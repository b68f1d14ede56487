// The decode-attention kernels shared by the port's paged decode (Pallas
// kernels 1 and 5), speculative verification (kernel 6) and dense decode
// (kernel 7) entry points.
//
// Each query row scores K/V rows of one KV head of one sequence, row t of
// which lives where a row-addressing policy says: a page-table lookup into
// a pool (N, K, ps, d) (PagedRows) or base + strides into a dense cache
// (StridedRows). A load policy turns 16 bytes of the cache into float32
// (float, fp8 E4M3 and int8 caches; int8 rows also carry a float32 scale).
// A KV head has R = V * G query rows: the G query heads of the KV head
// (head h reads KV head h / G) for each of V window rows, laid out
// window-major (row v * G + g), as the reference's verify kernel lays them
// out. Window row v attends the first lengths[b] + v + len_add rows
// (len_add 0 for decode, where V = 1; 1 for verify, whose lengths are the
// context before the window), clamped to the cache.
//
// Any group: a block holds one chunk of a KV head's R rows, at most
// kMaxRows rows and kThreads * kMaxAcc = 4096 query elements (the query
// elements its threads hold in registers): 32 rows at d 128, 64 at d 64.
// The chunks of a KV head are ceil(R / that) equal runs of consecutive
// rows, folded into grid.x (KV head * chunks + chunk). Each block is the
// block of an unchunked call restricted to its rows: it copies the split's
// K/V rows up to its own widest horizon and keeps its rows' partials in the
// layout of all R rows, so the merge is unchanged. Chunks across the grid,
// not a loop over chunks inside a block: each chunk re-reads the split's
// K/V tile, from L2 (one granite-34b layer, MQA with G = 48, at 8 slots x
// 1,504 rows is 0.77 MB), and K = 1 gets more blocks on the card (granite's
// decode runs 2 chunks, its k = 3 verify 192 rows in 6). A row's arithmetic
// does not depend on the chunking: scores and softmax are per row, and P V's
// row slicing depends on G and d alone (below), so verify row v still
// equals decode at lengths[b] + v + 1 bit for bit whatever chunks hold
// them. A chunk may span window rows; each row keeps its own horizon.
//
// Bound on the H100: every call reads each resident K and V row once and
// does about 4 * R * d flops per row, a few flops per byte, so it is bound
// by bytes. The context is split across blocks so that enough of them run
// (decode_split_kernel, then decode_merge_kernel):
//   * a grid of (KV head x row chunk, sequence, split): split s walks the
//     fixed rows
//     [s * kSplitRows, (s + 1) * kSplitRows), and the split count,
//     ceil(cap / kSplitRows) for the cache's (or page table's) row capacity
//     cap, depends on the cache's shape only, never on the lengths (which
//     live on the device), so a sequence's arithmetic does not depend on
//     the batch beside it;
//   * the split's K and V rows up to the widest window row's horizon (and
//     for int8 their scales) are copied to shared memory with cp.async
//     copies issued together with the query loads, in rows padded by 16
//     bytes; rows past that horizon are zero-filled, not read. A row's
//     address does not wait on the length: rows past the capacity are
//     clamped to its last row, so a slot whose table points at the null
//     page reads only in-bounds rows;
//   * each thread scores whole K rows against its query rows (no sums
//     across lanes); a row past its window row's horizon is masked to
//     -1e30. One warp per query row takes the split's softmax
//     (p = 0 where the score is <= -1e30 / 2). P V runs window row by
//     window row over slices of the rows so that every thread works; the
//     slicing depends on G and d alone and each window row's sums stop at
//     its own horizon, so window row v computes, operation for operation,
//     what V = 1 computes at lengths[b] + v + len_add. An int8 row's scales
//     enter once per row: the score is the dot product with the codes times
//     the K scale, and P V weighs the codes of V row r by p_r times its V
//     scale (the denominator sums p_r alone);
//   * each split writes a float32 partial (m, l, acc) of each query row to
//     a workspace the caller allocates; a row whose horizon ends before the
//     split writes m = -1e30, l = 0, acc = 0 (the whole block returns early
//     when that holds for its widest row);
//   * a second launch, scheduled while the first runs (programmatic
//     dependent launch), merges each (KV head, sequence)'s splits in the
//     fixed order 0, 1, ..., one thread per output element: weights
//     exp(m_s - max m), 0 for an empty split, so it drops out exactly; the
//     denominator clamped at 1e-30.

#pragma once

#include <cuda_fp8.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAcc = 16;     // query elements per thread: 4096 a block
constexpr int kMaxRows = 64;    // query rows per block: bounds shared memory
constexpr int kSplitRows = 64;  // context rows per split block
constexpr int kMergeRegs = 16;  // splits the merge loads per chunk
constexpr float kNegInf = -1.0e30f;

// 16 bytes of a float cache as float32, exactly (bfloat16 is the top
// half of a float32)
template <typename E>
struct Unpack16;
template <>
struct Unpack16<float> {
  static __device__ __forceinline__ void run(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Unpack16<__nv_bfloat16> {
  static __device__ __forceinline__ void run(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Unpack16<__half> {
  static __device__ __forceinline__ void run(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __half2float(__ushort_as_half(
          static_cast<unsigned short>(w[i] & 0xffffu)));
      f[2 * i + 1] = __half2float(__ushort_as_half(
          static_cast<unsigned short>(w[i] >> 16)));
    }
  }
};

// Load policies: the cache's element type, whether each row carries a
// float32 scale (int8), and the unpacking of 16 bytes (kVec elements, the
// lowest address first) into float32, exactly.
template <typename E>
struct LoadFloat {
  using Elem = E;
  static constexpr bool kScaled = false;
  static constexpr int kVec = 16 / sizeof(E);
  static __device__ __forceinline__ void vec(const uint4& u, float* f) {
    Unpack16<E>::run(u, f);
  }
};
// fp8 E4M3 codes, two at a time through the hardware's conversion to half:
// exact, since every E4M3 value (subnormals included) is a half, and codes
// 0x7F / 0xFF give NaN, as the plain version's 256-entry table
// (repro_torch/kernels/quant.py fp8_table) decodes them
struct LoadE4M3 {
  using Elem = unsigned char;
  static constexpr bool kScaled = false;
  static constexpr int kVec = 16;
  static __device__ __forceinline__ void vec(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 x = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
            static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * j)),
            __NV_E4M3)));
        f[4 * i + 2 * j] = x.x;
        f[4 * i + 2 * j + 1] = x.y;
      }
  }
};
struct LoadInt8 {
  using Elem = signed char;
  static constexpr bool kScaled = true;
  static constexpr int kVec = 16;
  static __device__ __forceinline__ void vec(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] = static_cast<float>(
            static_cast<signed char>((w[i] >> (8 * j)) & 0xFFu));
  }
};

// Row-addressing policies. row() names row t of (sequence b, KV head kh):
// its index in the scales' row space (scaled loads), from which elem()
// gives the element offset of its first element; cap() is the number of
// rows a sequence can address.
struct PagedRows {  // pools (N, K, ps, d) through a (B, P) page table
  const int* table;
  int ps, P, N, K;
  __host__ __device__ __forceinline__ int cap() const { return P * ps; }
  // out-of-range page ids read page 0, the null page
  __device__ __forceinline__ long long row(int b, int kh, int t) const {
    int page = table[static_cast<size_t>(b) * P + t / ps];
    if (page < 0 || page >= N) page = 0;
    return (static_cast<long long>(page) * K + kh) * ps + (t % ps);
  }
  __device__ __forceinline__ long long elem(long long row, int d) const {
    return row * d;
  }
};
struct StridedRows {  // a dense (B, K, T, d) view: element strides per axis
  long long sb, sk, st;
  int T;
  __host__ __device__ __forceinline__ int cap() const { return T; }
  __device__ __forceinline__ long long row(int b, int kh, int t) const {
    return b * sb + kh * sk + t * st;
  }
  __device__ __forceinline__ long long elem(long long row, int) const {
    return row;
  }
};

// Partials of one (sequence, KV head, split), R query rows: m[R], l[R],
// then acc[R][d]; splits of a (sequence, KV head) are adjacent.
__device__ __forceinline__ size_t partial_offset(int b, int kh, int s,
                                                 int K, int nsplit, int R,
                                                 int d) {
  return ((static_cast<size_t>(b) * K + kh) * nsplit + s) * R * (d + 2);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the 16 bytes when !valid
__device__ __forceinline__ void copy16_async(void* dst, const void* src,
                                             bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// the same for one float
__device__ __forceinline__ void copy4_async(float* dst, const float* src,
                                            bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// Shared memory of the split kernel: the K and V rows (padded by 16 bytes
// so that threads reading consecutive rows hit distinct banks), the scaled
// query rows, the scores (then weights), one window row's P V partial sums,
// and for scaled loads the rows' K and V scales.
template <typename E>
__host__ __device__ constexpr int split_row_ld(int d) {
  return d + 16 / static_cast<int>(sizeof(E));
}
// P V of one window row's heads in a chunk (at most min(G, rows) of
// them): heads * (d / kVec) items of kVec sums, in max(1, kThreads / (G *
// (d / kVec))) row slices each, so at most kThreads items in all when
// there is more than one slice
template <typename Load>
__host__ __device__ inline int split_red_floats(int G, int rows, int d) {
  const int heads = G < rows ? G : rows;
  return kThreads * Load::kVec > heads * d ? kThreads * Load::kVec
                                           : heads * d;
}
// query rows per block for R rows of head dim d: ceil(R / cap) equal
// chunks, cap = min(kMaxRows, kThreads * kMaxAcc / d)
__host__ __device__ inline int split_chunk_rows(int R, int d) {
  const int cap = kMaxRows < kThreads * kMaxAcc / d ? kMaxRows
                                                     : kThreads * kMaxAcc / d;
  const int nchunk = (R + cap - 1) / cap;
  return (R + nchunk - 1) / nchunk;
}
template <typename Load>
__host__ __device__ inline int split_smem_bytes(int G, int rows, int d) {
  using E = typename Load::Elem;
  const int scales = Load::kScaled ? 2 * kSplitRows : 0;
  return 2 * kSplitRows * split_row_ld<E>(d) * static_cast<int>(sizeof(E)) +
         (rows * d + rows * kSplitRows + split_red_floats<Load>(G, rows, d) +
          scales) *
             static_cast<int>(sizeof(float));
}

// kWindow: the block holds V window rows (verification, and paged decode of
// float and fp8 pools, which must equal it row for row and so runs the same
// instances); without it V = 1 and len_add = 0 are constants (dense decode,
// int8 paged decode), which keeps their index arithmetic, and their time,
// that of a kernel written for one window row. chunk_rows: the query rows
// per block (split_chunk_rows), so grid.x is K * ceil(R / chunk_rows).
template <typename Load, typename Rows, bool kWindow>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const void* __restrict__ q,
                    const typename Load::Elem* __restrict__ kc,
                    const typename Load::Elem* __restrict__ vc,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale, const Rows rows,
                    const int* __restrict__ lengths,
                    float* __restrict__ part, int H, int K, int d,
                    int window, int window_add, int chunk_rows, float scale,
                    bool q_bf16) {
  using E = typename Load::Elem;
  const int V = kWindow ? window : 1, len_add = kWindow ? window_add : 0;
  constexpr int kVec = Load::kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / K, R = V * G, nch = d / kVec, ld = split_row_ld<E>(d);
  E* k_sh = reinterpret_cast<E*>(smem_raw);                  // 64 x ld
  E* v_sh = k_sh + kSplitRows * ld;                          // 64 x ld
  float* q_sh = reinterpret_cast<float*>(v_sh + kSplitRows * ld);  // rows x d
  float* w_sh = q_sh + chunk_rows * d;  // rows x 64: scores, then weights
  float* red_sh = w_sh + chunk_rows * kSplitRows;
  float* ks_sh = red_sh + split_red_floats<Load>(G, chunk_rows, d);
  float* vs_sh = ks_sh + kSplitRows;  // scaled loads: 64 + 64

  // the merge launch may start; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int nchunk = (R + chunk_rows - 1) / chunk_rows;
  const int kh = blockIdx.x / nchunk, b = blockIdx.y, split = blockIdx.z;
  // this block's query rows [r0, r0 + Rc) of the KV head's R
  const int r0 = (blockIdx.x - kh * nchunk) * chunk_rows;
  const int Rc = min(chunk_rows, R - r0);
  const int tid = threadIdx.x;
  const int t0 = split * kSplitRows;
  const int last = min(kSplitRows, rows.cap() - t0) - 1;  // >= 0
  // window row v's valid rows in the split: min(last + 1, n0 + v)
  const int n0 = lengths[b] + len_add - t0;
  const int v_lo = kWindow ? r0 / G : 0;
  const int v_hi = kWindow ? (r0 + Rc - 1) / G : 0;
  const int n = min(last + 1, n0 + v_hi);  // the block's widest window row's

  // Every global load is issued before any is waited on: the split's K/V
  // rows up to the widest horizon, copied to shared memory (the others
  // zero-filled and masked below; addresses clamped to the cache, so they
  // do not wait on the length), their scales, and the query rows.
  for (int i = tid; i < kSplitRows * nch; i += kThreads) {
    const int r = i / nch, c = (i - r * nch) * kVec;
    const long long off = rows.elem(rows.row(b, kh, t0 + min(r, last)), d) + c;
    copy16_async(k_sh + r * ld + c, kc + off, r < n);
    copy16_async(v_sh + r * ld + c, vc + off, r < n);
  }
  if constexpr (Load::kScaled) {
    if (tid < kSplitRows) {
      const long long row = rows.row(b, kh, t0 + min(tid, last));
      copy4_async(ks_sh + tid, kscale + row, tid < n);
      copy4_async(vs_sh + tid, vscale + row, tid < n);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // element i of the block's rows is element gi = r0 d + i of the KV
  // head's; query row v * G + g is q[b, v, kh * G + g, :]
  float qx[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int i = tid + j * kThreads, gi = r0 * d + i;
    const int v = kWindow ? gi / (G * d) : 0;
    const size_t qi =
        (static_cast<size_t>(b * V + v) * H + kh * G) * d + (gi - v * G * d);
    qx[j] = i >= Rc * d ? 0.f
            : q_bf16    ? to_f32(static_cast<const __nv_bfloat16*>(q)[qi])
                        : static_cast<const float*>(q)[qi];
  }
  float* pm = part + partial_offset(b, kh, split, K, gridDim.z, R, d);
  if (n <= 0) {  // wholly past every window row: drops out of the merge
    for (int i = tid; i < Rc; i += kThreads) {
      pm[r0 + i] = kNegInf;
      pm[R + r0 + i] = 0.f;
    }
    for (int i = tid; i < Rc * d; i += kThreads) pm[2 * R + r0 * d + i] = 0.f;
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // before exiting
    return;
  }
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < Rc * d) q_sh[i] = qx[j] * scale;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // scores: thread (row r, query rows gs, gs + 4, ...) takes the whole dot
  // product of its staged K row, in kVec running sums over the row's
  // 16-byte chunks added at the end: no sums across lanes
  {
    constexpr int kRowSets = kThreads / kSplitRows;
    const int r = tid % kSplitRows;
    const uint4* krow = reinterpret_cast<const uint4*>(k_sh + r * ld);
    for (int g = tid / kSplitRows; g < Rc; g += kRowSets) {
      const int nv = kWindow ? min(last + 1, n0 + (r0 + g) / G) : n;
      const float4* qg = reinterpret_cast<const float4*>(q_sh + g * d);
      float a[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) a[e] = 0.f;
#pragma unroll 4
      for (int c = 0; c < nch; ++c) {
        float kf[kVec];
        Load::vec(krow[c], kf);
#pragma unroll
        for (int u = 0; u < kVec / 4; ++u) {
          const float4 x = qg[c * (kVec / 4) + u];
          a[4 * u] += x.x * kf[4 * u];
          a[4 * u + 1] += x.y * kf[4 * u + 1];
          a[4 * u + 2] += x.z * kf[4 * u + 2];
          a[4 * u + 3] += x.w * kf[4 * u + 3];
        }
      }
      float sum = a[0];
#pragma unroll
      for (int e = 1; e < kVec; ++e) sum += a[e];
      if constexpr (Load::kScaled) sum *= ks_sh[r];
      w_sh[g * kSplitRows + r] = r < nv ? sum : kNegInf;
    }
  }
  __syncthreads();

  // the split's softmax: warp w takes the block's rows w, w + 8, ...; lane
  // j holds K/V rows j and j + 32. P V's weights are p (times the row's V
  // scale for scaled loads); l sums p. A query row with no valid row here
  // gets m = -1e30, l = 0 (and acc = 0 below).
  const int lane = tid & 31, warp = tid >> 5;
  for (int g = warp; g < Rc; g += kWarps) {
    float* w = w_sh + g * kSplitRows;
    const float s0 = w[lane], s1 = w[lane + 32];
    const float m = warp_max(fmaxf(s0, s1));
    const float p0 = s0 <= kNegInf / 2 ? 0.f : expf(s0 - m);
    const float p1 = s1 <= kNegInf / 2 ? 0.f : expf(s1 - m);
    const float l = warp_sum(p0 + p1);
    if constexpr (Load::kScaled) {
      w[lane] = p0 * vs_sh[lane];
      w[lane + 32] = p1 * vs_sh[lane + 32];
    } else {
      w[lane] = p0;
      w[lane + 32] = p1;
    }
    if (lane == 0) {
      pm[r0 + g] = m;
      pm[R + r0 + g] = l;
    }
  }

  // acc = P V, one window row at a time over its own valid rows, for the
  // heads [ga, gb) of that window row the block holds. Item (query head g,
  // 16-byte chunk c of its output row); rs row slices per item, slice j
  // summing rows j, j + rs, ... so that all threads work; the slices are
  // then added in order 0, 1, .... The slicing depends on G and d alone,
  // never on V or the chunk.
  const int rs = max(1, kThreads / (G * nch));
  for (int v = v_lo; v <= v_hi; ++v) {
    const int nv = min(last + 1, n0 + v);
    const int ga = max(r0, v * G) - v * G;
    const int items = (min(r0 + Rc, (v + 1) * G) - v * G - ga) * nch;
    __syncthreads();  // the weights, or the last window row's sums, are in
    for (int it = tid; it < items * rs; it += kThreads) {
      const int slice = it / items, item = it - slice * items;
      const int g = ga + item / nch, c = item % nch;
      const float* w = w_sh + (v * G + g - r0) * kSplitRows;
      float acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll 4
      for (int r = slice; r < nv; r += rs) {
        float x[kVec];
        Load::vec(reinterpret_cast<const uint4*>(v_sh + r * ld)[c], x);
        const float p = w[r];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] += p * x[e];
      }
      float* red = red_sh + static_cast<size_t>(it) * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) red[e] = acc[e];
    }
    __syncthreads();
    for (int it = tid; it < items; it += kThreads) {
      const int g = ga + it / nch, c = it % nch;
      float acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = red_sh[it * kVec + e];
      for (int j = 1; j < rs; ++j) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[e] += red_sh[(static_cast<size_t>(j) * items + it) * kVec + e];
      }
      float* dst = pm + 2 * R + (v * G + g) * d + c * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[e] = acc[e];
    }
  }
}

// Merge the splits of each (KV head, sequence) in order 0, 1, ... into
// out (B, V, H, d) of type O (float or __nv_bfloat16): one thread per
// output element, a grid of (KV head, sequence, ceil(R d / 256)). Splits
// are read in chunks of kMergeRegs, each chunk's loads in flight together:
// a pass for the largest m, then one for the weighted sums.
template <typename O>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part, O* __restrict__ out,
                    int H, int K, int d, int V, int nsplit) {
  // launched while the split grid runs: wait for its partials
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int kh = blockIdx.x, b = blockIdx.y, G = H / K, R = V * G;
  const int i = blockIdx.z * kThreads + threadIdx.x;
  if (i >= R * d) return;
  const int g = i / d, v = V > 1 ? g / G : 0;
  const float* base = part + partial_offset(b, kh, 0, K, nsplit, R, d);
  const size_t stride = static_cast<size_t>(R) * (d + 2);
  float top = kNegInf;
  for (int s0 = 0; s0 < nsplit; s0 += kMergeRegs) {
    float m[kMergeRegs];
#pragma unroll
    for (int s = 0; s < kMergeRegs; ++s)
      m[s] = s0 + s < nsplit ? base[(s0 + s) * stride + g] : kNegInf;
#pragma unroll
    for (int s = 0; s < kMergeRegs; ++s) top = fmaxf(top, m[s]);
  }
  float den = 0.f, num = 0.f;
  for (int s0 = 0; s0 < nsplit; s0 += kMergeRegs) {
    float m[kMergeRegs], l[kMergeRegs], a[kMergeRegs];
#pragma unroll
    for (int s = 0; s < kMergeRegs; ++s) {
      const bool ok = s0 + s < nsplit;
      const float* p = base + (s0 + s) * stride;
      m[s] = ok ? p[g] : kNegInf;
      l[s] = ok ? p[R + g] : 0.f;
      a[s] = ok ? p[2 * R + i] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < kMergeRegs; ++s) {
      if (s0 + s < nsplit) {
        const float w = m[s] <= kNegInf / 2 ? 0.f : expf(m[s] - top);
        den += l[s] * w;
        num += a[s] * w;
      }
    }
  }
  out[(static_cast<size_t>(b * V + v) * H + kh * G) * d + (i - v * G * d)] =
      from_f32<O>(num / fmaxf(den, 1e-30f));
}

// Launch one decode-attention call: q, out (B, V, H, d) contiguous in q's
// type (q_dtype 0 float32, 1 bfloat16); ks, vs the per-row scales of a
// scaled load (else null); part holds B * K * nsplit * V * (H / K) * (d + 2)
// floats, nsplit = ceil(cap / kSplitRows). Refuses (cudaErrorInvalidValue)
// what the kernel does not take: a head dim that is not a whole number of
// 16-byte chunks or is above 256, a scaled load without scales, window
// rows (V > 1 or len_add > 0) without kWindow. Any group and window: the
// V * H / K query rows of a KV head run in split_chunk_rows chunks. Every
// row must start 16-byte aligned (the caller checks).
template <typename Load, bool kWindow, typename Rows>
cudaError_t launch_decode_split(const void* q, const void* kc, const void* vc,
                                const float* ks, const float* vs,
                                const Rows& rows, const int* lengths,
                                float* part, void* out, int B, int H, int K,
                                int d, int V, int len_add, int nsplit,
                                float scale, int q_dtype,
                                cudaStream_t stream) {
  using E = typename Load::Elem;
  if (q_dtype != kF32 && q_dtype != kBF16) return cudaErrorInvalidValue;
  if (K <= 0 || H % K || V < 1 || nsplit <= 0 || part == nullptr ||
      (Load::kScaled && (ks == nullptr || vs == nullptr)) ||
      (!kWindow && (V != 1 || len_add != 0)))
    return cudaErrorInvalidValue;
  if (d <= 0 || d % Load::kVec || d > 256) return cudaErrorInvalidValue;
  const int G = H / K, R = V * G, chunk_rows = split_chunk_rows(R, d);
  const int nchunk = (R + chunk_rows - 1) / chunk_rows;
  const int smem = split_smem_bytes<Load>(G, chunk_rows, d);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<Load, Rows, kWindow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool q_bf16 = q_dtype == kBF16;
  decode_split_kernel<Load, Rows, kWindow>
      <<<dim3(K * nchunk, B, nsplit), kThreads, smem, stream>>>(
      q, static_cast<const E*>(kc), static_cast<const E*>(vc), ks, vs, rows,
      lengths, part, H, K, d, V, len_add, chunk_rows, scale, q_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // programmatic dependent launch: the merge is scheduled while the split
  // grid runs and waits for it in griddepcontrol.wait
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K, B, (R * d + kThreads - 1) / kThreads);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* pc = part;
  if (q_bf16)
    return cudaLaunchKernelEx(&cfg, decode_merge_kernel<__nv_bfloat16>, pc,
                              static_cast<__nv_bfloat16*>(out), H, K, d, V,
                              nsplit);
  return cudaLaunchKernelEx(&cfg, decode_merge_kernel<float>, pc,
                            static_cast<float*>(out), H, K, d, V, nsplit);
}

// The paged pools of kernels 1 and 6 (pool_dtype kF32, kBF16, kF16 or
// kE4M3; float or fp8 codes, no scales): V window rows, nsplit =
// ceil(P * ps / kSplitRows) from the table's width.
template <typename Rows>
cudaError_t launch_paged_split(const void* q, const void* kp, const void* vp,
                               const Rows& rows, const int* lengths,
                               float* part, void* out, int B, int H, int K,
                               int d, int V, int len_add, int nsplit,
                               float scale, int q_dtype, int pool_dtype,
                               cudaStream_t s) {
  if (nsplit != (rows.cap() + kSplitRows - 1) / kSplitRows)
    return cudaErrorInvalidValue;
#define TRAPTI_PAGED(LOAD)                                                \
  launch_decode_split<LOAD, true>(q, kp, vp, nullptr, nullptr, rows,      \
                                  lengths, part, out, B, H, K, d, V,      \
                                  len_add, nsplit, scale, q_dtype, s)
  if (pool_dtype == kF32) return TRAPTI_PAGED(LoadFloat<float>);
  if (pool_dtype == kBF16) return TRAPTI_PAGED(LoadFloat<__nv_bfloat16>);
  if (pool_dtype == kF16) return TRAPTI_PAGED(LoadFloat<__half>);
  if (pool_dtype == kE4M3) return TRAPTI_PAGED(LoadE4M3);
#undef TRAPTI_PAGED
  return cudaErrorInvalidValue;
}

}  // namespace
