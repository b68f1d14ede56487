// The decode-attention kernel template shared by the port's paged decode
// (Pallas kernels 1 and 5), speculative verification (kernel 6) and dense
// decode (kernel 7) entry points.
//
// Each query row scores K/V rows of one KV head of one sequence, row t of
// which lives where a row-addressing policy says: a page-table lookup into
// a pool (N, K, ps, d) (PagedRows) or base + strides into a dense cache
// (StridedRows). A block holds R = V * G query rows: the G query heads of
// the KV head (head h reads KV head h / G) for each of V window rows, laid
// out window-major (row v * G + g), as the reference's verify kernel lays
// them out. Window row v attends the first lengths[b] + v + len_add rows
// (len_add 0 for decode, where V = 1; 1 for verify, whose lengths are the
// context before the window), clamped to the cache.
//
// Bound on the H100: every call reads each resident K and V row once and
// does about 4 * R * d flops per row, a few flops per byte, so it is bound
// by bytes. Two paths share the load and row-addressing policies:
//
// The unsplit path (decode_attention_kernel; paged decode of float and fp8
// pools, verification):
//   * one block per (KV head, sequence), walking the context in tiles of 32
//     rows up to the widest window row's horizon;
//   * the R query rows share each row load: a warp loads one K row into
//     registers (coalesced) and scores it against every query row held in
//     shared memory; a query row past its own horizon gets -1e30, so a tile
//     beyond it leaves the row's m, l and accumulators exactly unchanged
//     (corr = exp(0) = 1, p = 0). Row v therefore computes what V = 1 would
//     compute at length lengths[b] + v + len_add, operation for operation;
//   * float32 online softmax across tiles (m, l in shared memory, the
//     output accumulators in registers); p = 0 where the score is <= -1e30
//     / 2 and the denominator is clamped at 1e-30, as in the reference;
//   * V rows are read coalesced by the threads that own consecutive output
//     dimensions.
//   Only K x B blocks run (16 for dsr1d at 8 sequences, 2 at one).
//
// The split-context path (decode_split_kernel + decode_merge_kernel; V = 1:
// dense decode of float caches, and paged decode of int8 pools with per-row
// scales):
//   * a grid of (KV head, sequence, split): split s walks the fixed rows
//     [s * kSplitRows, (s + 1) * kSplitRows), and the split count,
//     ceil(cap / kSplitRows) for the cache's (or page table's) row capacity
//     cap, depends on the cache's shape only, never on the lengths (which
//     live on the device), so a sequence's arithmetic does not depend on
//     the batch beside it;
//   * the split's valid K and V rows (and for int8 their scales) are copied
//     to shared memory with cp.async copies issued together with the query
//     loads, in rows padded by 16 bytes; rows past the sequence are
//     zero-filled, not read. A row's address does not wait on the length:
//     rows past the capacity are clamped to its last row, so a slot whose
//     table points at the null page reads only in-bounds rows;
//   * each thread scores whole K rows against its query rows (no sums
//     across lanes), one warp per query row takes the split's softmax, and
//     P V runs over slices of the rows so that every thread works. An int8
//     row's scales enter once per row: the score is the dot product with
//     the codes times the K scale, and P V weighs the codes of V row r by
//     p_r times its V scale (the denominator sums p_r alone);
//   * each split writes a float32 partial (m, l, acc) of its rows to a
//     workspace the caller allocates; a split wholly past lengths[b]
//     writes m = -1e30, l = 0, acc = 0;
//   * a second launch, scheduled while the first runs (programmatic
//     dependent launch), merges each (KV head, sequence)'s splits in the
//     fixed order 0, 1, ..., one thread per output element: weights
//     exp(m_s - max m), 0 for an empty split, so it drops out exactly; the
//     denominator clamped at 1e-30.
// Paged decode of float and fp8 pools (kernel 1) and verification (kernel
// 6) stay on the unsplit path, where verify row v computes exactly what
// kernel 1 computes at lengths[b] + v + 1; they move to the split path
// together.

#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;     // context rows per tile (one per lane in softmax)
constexpr int kMaxAcc = 16;   // outputs per thread: R * d <= 4096
constexpr int kMaxRows = 64;  // query rows per block: bounds shared memory
constexpr float kNegInf = -1.0e30f;

// E4M3 code -> float32, exact: sign, 4 exponent bits (bias 7), 3 mantissa
// bits; exponent 0 is subnormal (m * 2^-9), 0x7F / 0xFF are NaN. The plain
// version's 256-entry table (repro_torch/kernels/quant.py fp8_table) is
// built by the same rule.
__device__ __forceinline__ float e4m3_to_f32(unsigned int c) {
  const unsigned int e = (c >> 3) & 0xFu, m = c & 0x7u;
  float mag;
  if (e == 0)
    mag = static_cast<float>(m) * 0.001953125f;
  else if (e == 15 && m == 7)
    mag = __int_as_float(0x7fc00000);
  else
    mag = __int_as_float(static_cast<int>(((e + 120u) << 23) | (m << 20)));
  return (c & 0x80u) ? -mag : mag;
}

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

// Load policies: the cache's element type, its float32 value, and whether
// each row carries a float32 scale (int8, split path only); float and int8
// caches also unpack 16 bytes (kVec elements) at once for the split path.
template <typename E>
struct LoadFloat {
  using Elem = E;
  static constexpr bool kScaled = false;
  static constexpr int kVec = 16 / sizeof(E);
  static __device__ __forceinline__ float get(const E* p, long long i) {
    return to_f32(p[i]);
  }
  static __device__ __forceinline__ void vec(const uint4& u, float* f) {
    Unpack16<E>::run(u, f);
  }
};
struct LoadE4M3 {
  using Elem = unsigned char;
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ float get(const Elem* p, long long i) {
    return e4m3_to_f32(p[i]);
  }
};
struct LoadInt8 {
  using Elem = signed char;
  static constexpr bool kScaled = true;
  static constexpr int kVec = 16;
  // 16 int8 codes as float32 (exact), the lowest address first
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
// its index in the scales' row space (scaled loads, split path), from
// which elem() gives the element offset of its first element; cap() is the
// number of rows a sequence can address.
struct PagedRows {  // pools (N, K, ps, d) through a (B, P) page table
  const int* table;
  int ps, P, N, K;
  __device__ __forceinline__ int cap() const { return P * ps; }
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
  __device__ __forceinline__ int cap() const { return T; }
  __device__ __forceinline__ long long row(int b, int kh, int t) const {
    return b * sb + kh * sk + t * st;
  }
  __device__ __forceinline__ long long elem(long long row, int) const {
    return row;
  }
};

template <typename Load, typename Rows, int DC>  // DC: dims per lane
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const void* __restrict__ q,
                        const typename Load::Elem* __restrict__ kc,
                        const typename Load::Elem* __restrict__ vc,
                        const Rows rows,
                        const int* __restrict__ lengths,
                        void* __restrict__ out, int H, int K, int d, int V,
                        int len_add, float scale, bool q_bf16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / K, R = V * G;
  long long* row_off = reinterpret_cast<long long*>(smem_raw);  // kTile
  float* q_sh = reinterpret_cast<float*>(row_off + kTile);      // R * d
  float* w_sh = q_sh + R * d;      // R * kTile: scores, then weights
  float* m_sh = w_sh + R * kTile;  // R
  float* l_sh = m_sh + R;          // R
  float* c_sh = l_sh + R;          // R: this tile's rescale factor

  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // row v * G + g may attend rows t < base + v; the block walks to the
  // widest window row's horizon
  const int base = lengths[b] + len_add;
  const int len = min(base + V - 1, rows.cap());

  // query row i = v * G + g is head kh * G + g of window row v
  for (int i = tid; i < R * d; i += kThreads) {
    const int r = i / d, c = i - r * d, v = r / G, g = r - v * G;
    const size_t qi =
        ((static_cast<size_t>(b) * V + v) * H + kh * G + g) * d + c;
    q_sh[i] = (q_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(q)[qi])
                      : static_cast<const float*>(q)[qi]) *
              scale;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_sh[r] = kNegInf;
    l_sh[r] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);
    // scores: warp w scores context rows w, w + 8, ... of the tile against
    // every query row; query rows below `first` are past their horizon
    for (int r = warp; r < kTile; r += kWarps) {
      if (r < n) {
        const int t = t0 + r;
        const int first = max(0, (t - base + 1) * G);
        const long long off = rows.elem(rows.row(b, kh, t), d);
        if (lane == 0) row_off[r] = off;
        float kf[DC];
#pragma unroll
        for (int i = 0; i < DC; ++i) {
          const int c = lane + 32 * i;
          kf[i] = c < d ? Load::get(kc, off + c) : 0.f;
        }
        if (lane == 0)
          for (int g = 0; g < min(first, R); ++g) w_sh[g * kTile + r] = kNegInf;
        for (int g = first; g < R; ++g) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < DC; ++i) {
            const int c = lane + 32 * i;
            if (c < d) part += q_sh[g * d + c] * kf[i];
          }
          part = warp_sum(part);
          if (lane == 0) w_sh[g * kTile + r] = part;
        }
      } else if (lane == 0) {
        for (int g = 0; g < R; ++g) w_sh[g * kTile + r] = kNegInf;
      }
    }
    __syncthreads();
    // online softmax: warp w handles query rows w, w + 8, ...; lane = row
    for (int g = warp; g < R; g += kWarps) {
      const float sv = w_sh[g * kTile + lane];
      const float m_prev = m_sh[g];
      const float m_new = fmaxf(m_prev, warp_max(sv));
      const float p = sv <= kNegInf / 2 ? 0.f : expf(sv - m_new);
      const float corr = expf(m_prev - m_new);
      const float psum = warp_sum(p);
      w_sh[g * kTile + lane] = p;
      if (lane == 0) {
        m_sh[g] = m_new;
        l_sh[g] = l_sh[g] * corr + psum;
        c_sh[g] = corr;
      }
    }
    __syncthreads();
    // accumulate: thread owns outputs (g, c) = divmod(tid + j * 256, d)
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int idx = tid + j * kThreads;
      if (idx < R * d) {
        const int g = idx / d, c = idx - g * d;
        float a = acc[j] * c_sh[g];
        const float* w = w_sh + g * kTile;
        for (int r = 0; r < n; ++r) a += w[r] * Load::get(vc, row_off[r] + c);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int idx = tid + j * kThreads;
    if (idx < R * d) {
      const int r = idx / d, c = idx - r * d, v = r / G, g = r - v * G;
      const size_t oi =
          ((static_cast<size_t>(b) * V + v) * H + kh * G + g) * d + c;
      const float o = acc[j] / fmaxf(l_sh[r], 1e-30f);
      if (q_bf16)
        static_cast<__nv_bfloat16*>(out)[oi] = __float2bfloat16(o);
      else
        static_cast<float*>(out)[oi] = o;
    }
  }
}

// Launch one decode-attention call: q, out (B, V, H, d) contiguous in q's
// type (float32, q_dtype 0, or bfloat16, 1). Refuses (cudaErrorInvalidValue)
// a query type, head dim (> 256) or row count (V * H / K > 64, or
// V * H / K * d > 4096) the kernel does not take.
template <typename Load, typename Rows>
cudaError_t launch_decode_attention(const void* q, const void* kc,
                                    const void* vc, const Rows& rows,
                                    const int* lengths, void* out, int B,
                                    int H, int K, int d, int V, int len_add,
                                    float scale, int q_dtype,
                                    cudaStream_t stream) {
  if (q_dtype != kF32 && q_dtype != kBF16) return cudaErrorInvalidValue;
  if (K <= 0 || H % K || V < 1) return cudaErrorInvalidValue;
  const int R = V * (H / K);
  if (R > kMaxRows || R * d > kThreads * kMaxAcc || d > 256)
    return cudaErrorInvalidValue;
  const dim3 grid(K, B);
  static_assert(!Load::kScaled, "scaled rows take the split path");
  const size_t smem = kTile * sizeof(long long) +
                      (R * d + R * kTile + 3 * R) * sizeof(float);
  using E = typename Load::Elem;
  const E* kp = static_cast<const E*>(kc);
  const E* vp = static_cast<const E*>(vc);
  const bool q_bf16 = q_dtype == kBF16;
  // head dims up to 64, 128 and 256: lanes past d are masked
#define TRAPTI_ATTEND(DC)                                                   \
  decode_attention_kernel<Load, Rows, DC><<<grid, kThreads, smem, stream>>>( \
      q, kp, vp, rows, lengths, out, H, K, d, V, len_add, scale,            \
      q_bf16)
  if (d <= 64) TRAPTI_ATTEND(2);
  else if (d <= 128) TRAPTI_ATTEND(4);
  else TRAPTI_ATTEND(8);
#undef TRAPTI_ATTEND
  return cudaGetLastError();
}

// ------------------------------------------------- split-context path
constexpr int kSplitRows = 64;  // context rows per split block
constexpr int kMergeRegs = 16;  // splits the merge loads per chunk

// Partials of one (sequence, KV head, split), G query rows: m[G], l[G],
// then acc[G][d]; splits of a (sequence, KV head) are adjacent.
__device__ __forceinline__ size_t partial_offset(int b, int kh, int s,
                                                 int K, int nsplit, int G,
                                                 int d) {
  return ((static_cast<size_t>(b) * K + kh) * nsplit + s) * G * (d + 2);
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
// query rows, the scores (then weights), P V's partial sums, and for
// scaled loads the rows' K and V scales.
template <typename E>
__host__ __device__ constexpr int split_row_ld(int d) {
  return d + 16 / static_cast<int>(sizeof(E));
}
template <typename Load>
__host__ __device__ inline int split_smem_bytes(int G, int d) {
  using E = typename Load::Elem;
  const int red = kThreads * Load::kVec > G * d ? kThreads * Load::kVec
                                                : G * d;
  const int scales = Load::kScaled ? 2 * kSplitRows : 0;
  return 2 * kSplitRows * split_row_ld<E>(d) * static_cast<int>(sizeof(E)) +
         (G * d + G * kSplitRows + red + scales) *
             static_cast<int>(sizeof(float));
}

template <typename Load, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const void* __restrict__ q,
                    const typename Load::Elem* __restrict__ kc,
                    const typename Load::Elem* __restrict__ vc,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale, const Rows rows,
                    const int* __restrict__ lengths,
                    float* __restrict__ part, int H, int K, int d,
                    float scale, bool q_bf16) {
  using E = typename Load::Elem;
  constexpr int kVec = Load::kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / K, nch = d / kVec, ld = split_row_ld<E>(d);
  E* k_sh = reinterpret_cast<E*>(smem_raw);                  // 64 x ld
  E* v_sh = k_sh + kSplitRows * ld;                          // 64 x ld
  float* q_sh = reinterpret_cast<float*>(v_sh + kSplitRows * ld);  // G x d
  float* w_sh = q_sh + G * d;  // G x 64: scores, then weights
  float* red_sh = w_sh + G * kSplitRows;  // max(256 kVec, G d)
  float* ks_sh = red_sh + (kThreads * kVec > G * d ? kThreads * kVec : G * d);
  float* vs_sh = ks_sh + kSplitRows;  // scaled loads: 64 + 64

  // the merge launch may start; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int kh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x;
  const int t0 = split * kSplitRows;
  const int last = min(kSplitRows, rows.cap() - t0) - 1;  // >= 0
  const int n = min(last + 1, lengths[b] - t0);  // the split's valid rows

  // Every global load is issued before any is waited on: the split's K/V
  // rows that the sequence holds, copied to shared memory (the others
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
  const size_t q0 = (static_cast<size_t>(b) * H + kh * G) * d;
  float qx[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int i = tid + j * kThreads;
    qx[j] = i >= G * d ? 0.f
            : q_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(q)[q0 + i])
                     : static_cast<const float*>(q)[q0 + i];
  }
  float* pm = part + partial_offset(b, kh, split, K, gridDim.z, G, d);
  if (n <= 0) {  // wholly past the sequence: drops out of the merge
    for (int i = tid; i < G; i += kThreads) {
      pm[i] = kNegInf;
      pm[G + i] = 0.f;
    }
    for (int i = tid; i < G * d; i += kThreads) pm[2 * G + i] = 0.f;
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // before exiting
    return;
  }
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < G * d) q_sh[i] = qx[j] * scale;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // scores: thread (row r, query rows g = gs, gs + 4, ...) takes the whole
  // dot product of its staged K row, in kVec running sums over the row's
  // 16-byte chunks added at the end: no sums across lanes
  {
    constexpr int kRowSets = kThreads / kSplitRows;
    const int r = tid % kSplitRows;
    const uint4* krow = reinterpret_cast<const uint4*>(k_sh + r * ld);
    for (int g = tid / kSplitRows; g < G; g += kRowSets) {
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
      w_sh[g * kSplitRows + r] = r < n ? sum : kNegInf;
    }
  }
  __syncthreads();

  // the split's softmax: warp w takes query rows w, w + 8, ...; lane j
  // holds rows j and j + 32. P V's weights are p (times the row's V scale
  // for scaled loads); l sums p.
  const int lane = tid & 31, warp = tid >> 5;
  for (int g = warp; g < G; g += kWarps) {
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
      pm[g] = m;
      pm[G + g] = l;
    }
  }
  __syncthreads();

  // acc = P V over the split's valid rows. Item (query row g, 16-byte
  // chunk c of its output row); rs row slices per item, slice j summing
  // rows j, j + rs, ... so that all threads work; the slices are then
  // added in order 0, 1, ...
  const int items = G * nch, rs = max(1, kThreads / items);
  for (int it = tid; it < items * rs; it += kThreads) {
    const int slice = it / items, item = it - slice * items;
    const int g = item / nch, c = item - g * nch;
    const float* w = w_sh + g * kSplitRows;
    float acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll 4
    for (int r = slice; r < n; r += rs) {
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
    const int g = it / nch, c = it - g * nch;
    float acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = red_sh[it * kVec + e];
    for (int j = 1; j < rs; ++j) {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc[e] += red_sh[(static_cast<size_t>(j) * items + it) * kVec + e];
    }
    float* dst = pm + 2 * G + g * d + c * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[e] = acc[e];
  }
}

// Merge the splits of each (KV head, sequence) in order 0, 1, ... into
// out (B, H, d) of type O (float or __nv_bfloat16): one thread per output
// element, a grid of (KV head, sequence, ceil(G d / 256)). Splits are read
// in chunks of kMergeRegs, each chunk's loads in flight together: a pass
// for the largest m, then one for the weighted sums.
template <typename O>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part, O* __restrict__ out,
                    int H, int K, int d, int nsplit) {
  // launched while the split grid runs: wait for its partials
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int kh = blockIdx.x, b = blockIdx.y, G = H / K;
  const int i = blockIdx.z * kThreads + threadIdx.x;
  if (i >= G * d) return;
  const int g = i / d;
  const float* base = part + partial_offset(b, kh, 0, K, nsplit, G, d);
  const size_t stride = static_cast<size_t>(G) * (d + 2);
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
      l[s] = ok ? p[G + g] : 0.f;
      a[s] = ok ? p[2 * G + i] : 0.f;
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
  out[(static_cast<size_t>(b) * H + kh * G) * d + i] =
      from_f32<O>(num / fmaxf(den, 1e-30f));
}

// Launch the split path for V = 1: q, out (B, H, d) contiguous in q's type
// (q_dtype 0 float32, 1 bfloat16); ks, vs the per-row scales of a scaled
// load (else null); part holds B * K * nsplit * G * (d + 2) floats,
// nsplit = ceil(cap / kSplitRows). Refuses (cudaErrorInvalidValue) what the
// path does not take: a head dim that is not a whole number of 16-byte
// chunks or is above 256, more than 64 query rows per KV head or 4096
// accumulators of them, a scaled load without scales. Every row must start
// 16-byte aligned (the caller checks).
template <typename Load, typename Rows>
cudaError_t launch_decode_split(const void* q, const void* kc, const void* vc,
                                const float* ks, const float* vs,
                                const Rows& rows, const int* lengths,
                                float* part, void* out, int B, int H, int K,
                                int d, int nsplit, float scale, int q_dtype,
                                cudaStream_t stream) {
  using E = typename Load::Elem;
  if (q_dtype != kF32 && q_dtype != kBF16) return cudaErrorInvalidValue;
  if (K <= 0 || H % K || nsplit <= 0 || part == nullptr ||
      (Load::kScaled && (ks == nullptr || vs == nullptr)))
    return cudaErrorInvalidValue;
  const int G = H / K;
  if (d % Load::kVec || d > 256 || G > kMaxRows ||
      G * d > kThreads * kMaxAcc)
    return cudaErrorInvalidValue;
  const int smem = split_smem_bytes<Load>(G, d);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<Load, Rows>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool q_bf16 = q_dtype == kBF16;
  decode_split_kernel<Load, Rows><<<dim3(K, B, nsplit), kThreads, smem,
                                    stream>>>(
      q, static_cast<const E*>(kc), static_cast<const E*>(vc), ks, vs, rows,
      lengths, part, H, K, d, scale, q_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // programmatic dependent launch: the merge is scheduled while the split
  // grid runs and waits for it in griddepcontrol.wait
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K, B, (G * d + kThreads - 1) / kThreads);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* pc = part;
  if (q_bf16)
    return cudaLaunchKernelEx(&cfg, decode_merge_kernel<__nv_bfloat16>, pc,
                              static_cast<__nv_bfloat16*>(out), H, K, d,
                              nsplit);
  return cudaLaunchKernelEx(&cfg, decode_merge_kernel<float>, pc,
                            static_cast<float*>(out), H, K, d, nsplit);
}

}  // namespace
