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
// by bytes. The design:
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
// Only K x B blocks run (16 for dsr1d at 8 sequences), so the kernel is far
// from its bound at the serving batch; splitting the context across blocks
// is later work.
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

// Load policies: the cache's element type, its float32 value, and whether
// each row carries a float32 scale.
template <typename E>
struct LoadFloat {
  using Elem = E;
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ float get(const E* p, long long i) {
    return to_f32(p[i]);
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
  static __device__ __forceinline__ float get(const Elem* p, long long i) {
    return static_cast<float>(p[i]);
  }
};

// Row-addressing policies. row() names row t of (sequence b, KV head kh):
// its index in the scales' row space (scaled loads only), from which
// elem() gives the element offset of its first element; cap() is the
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
                        const float* __restrict__ kscale,
                        const float* __restrict__ vscale, const Rows rows,
                        const int* __restrict__ lengths,
                        void* __restrict__ out, int H, int K, int d, int V,
                        int len_add, float scale, bool q_bf16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / K, R = V * G;
  long long* row_off = reinterpret_cast<long long*>(smem_raw);  // kTile
  float* vs_sh = reinterpret_cast<float*>(row_off + kTile);     // kTile
  float* q_sh = vs_sh + kTile;     // R * d
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
        const long long row = rows.row(b, kh, t);
        const long long off = rows.elem(row, d);
        float ks = 1.f;
        if constexpr (Load::kScaled) ks = kscale[row];
        if (lane == 0) {
          row_off[r] = off;
          if constexpr (Load::kScaled) vs_sh[r] = vscale[row];
        }
        float kf[DC];
#pragma unroll
        for (int i = 0; i < DC; ++i) {
          const int c = lane + 32 * i;
          float x = c < d ? Load::get(kc, off + c) : 0.f;
          if constexpr (Load::kScaled) x *= ks;
          kf[i] = x;
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
        for (int r = 0; r < n; ++r) {
          float x = Load::get(vc, row_off[r] + c);
          if constexpr (Load::kScaled) x *= vs_sh[r];
          a += w[r] * x;
        }
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
                                    const void* vc, const float* ks,
                                    const float* vs, const Rows& rows,
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
  const size_t smem = kTile * sizeof(long long) +
                      (kTile + R * d + R * kTile + 3 * R) * sizeof(float);
  using E = typename Load::Elem;
  const E* kp = static_cast<const E*>(kc);
  const E* vp = static_cast<const E*>(vc);
  const bool q_bf16 = q_dtype == kBF16;
  // head dims up to 64, 128 and 256: lanes past d are masked
#define TRAPTI_ATTEND(DC)                                                   \
  decode_attention_kernel<Load, Rows, DC><<<grid, kThreads, smem, stream>>>( \
      q, kp, vp, ks, vs, rows, lengths, out, H, K, d, V, len_add, scale,    \
      q_bf16)
  if (d <= 64) TRAPTI_ATTEND(2);
  else if (d <= 128) TRAPTI_ATTEND(4);
  else TRAPTI_ATTEND(8);
#undef TRAPTI_ATTEND
  return cudaGetLastError();
}

}  // namespace
