// Paged GQA decode attention for Hopper, over float, fp8 and int8 pools.
//
// Replaces two Pallas kernels of repro/kernels/paged_gqa_decode/kernel.py:
//   * paged_gqa_decode_kernel (_paged_decode_kernel): one query token per
//     slot against K/V rows that live in a global page pool (N, K, ps, d)
//     and are reached through the slot's page-table row; positions
//     >= lengths[b] (including the tail of a partially filled last page)
//     are masked. Pools hold float32, bfloat16, float16 or fp8 E4M3 codes,
//     read as float32 whatever the query's type (the reference casts both
//     to float32 in its body; kv_dtype="fp32" under a bf16 model gives
//     this mix). Entry point paged_gqa_decode_fwd.
//   * paged_gqa_decode_quant_kernel (_paged_decode_quant_kernel): the same
//     control flow and accumulator math on int8 pools, each row multiplied
//     by its float32 scale (pools (N, K, ps) of scales, reached through the
//     same page-table indirection as the row) in registers before use.
//     Entry point paged_gqa_decode_quant_fwd.
// One kernel template serves both: a load policy turns a pool element into
// float32 (and says whether rows carry a scale). The query's type is a
// run-time argument: q is read once and the output written once per block,
// outside the loops, so templating on it would only double the build.
//
// Bound on the H100: each call reads every resident K and V row once
// (2 * lengths * K * d elements per slot, plus 2 scales per row for int8)
// and does about 4 * H * d flops per row, a few flops per byte, so it is
// bound by bytes. The design:
//   * one block per (KV head, slot). The block reads the slot's page-table
//     row itself (the TPU scalar-prefetched it) and walks the context in
//     tiles of 32 rows, computing each row's page and offset, up to
//     lengths[b] (clamped to the table, so a slot that points at the null
//     page 0 reads only in-bounds rows; out-of-range page ids read page 0);
//   * the whole GQA group of the KV head shares each row load: a warp loads
//     one K row into registers (coalesced) and scores it against all
//     `group` query heads held in shared memory; head h reads KV head
//     h / group, as the reference's reshape of q to (B, K, group, d);
//   * float32 online softmax across tiles (m, l in shared memory, the output
//     accumulators in registers); p = 0 where the score is <= -1e30 / 2 and
//     the denominator is clamped at 1e-30, as in the reference;
//   * V rows are read coalesced by the threads that own consecutive output
//     dimensions.
// Only 16 blocks run for 8 slots x 2 KV heads (dsr1d), so the kernel is far
// from its bound at the main path's batch; splitting the context across
// blocks is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;     // context rows per tile (one per lane in softmax)
constexpr int kMaxAcc = 16;   // outputs per thread: group * d <= 4096
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

// Load policies: the pool's element type, its float32 value, and whether
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

template <typename Load, int DC>  // DC: dims per lane, d <= 32 * DC
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const void* __restrict__ q,
                    const typename Load::Elem* __restrict__ kpool,
                    const typename Load::Elem* __restrict__ vpool,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, void* __restrict__ out,
                    int H, int K, int d, int ps, int P, int N, float scale,
                    bool q_bf16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / K;
  long long* row_id = reinterpret_cast<long long*>(smem_raw);   // kTile
  float* vs_sh = reinterpret_cast<float*>(row_id + kTile);      // kTile
  float* q_sh = vs_sh + kTile;     // G * d
  float* w_sh = q_sh + G * d;      // G * kTile: scores, then weights
  float* m_sh = w_sh + G * kTile;  // G
  float* l_sh = m_sh + G;          // G
  float* c_sh = l_sh + G;          // G: this tile's rescale factor

  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* row_table = table + static_cast<size_t>(b) * P;
  const int len = min(lengths[b], P * ps);

  for (int i = tid; i < G * d; i += kThreads) {
    const int g = i / d, c = i - g * d;
    const size_t qi = (static_cast<size_t>(b) * H + kh * G + g) * d + c;
    q_sh[i] = (q_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(q)[qi])
                      : static_cast<const float*>(q)[qi]) *
              scale;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_sh[g] = kNegInf;
    l_sh[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);
    // scores: warp w scores rows w, w + 8, ... of the tile for every head
    for (int r = warp; r < kTile; r += kWarps) {
      if (r < n) {
        const int t = t0 + r;
        int page = row_table[t / ps];
        if (page < 0 || page >= N) page = 0;
        // the row's index in the pool's (N, K, ps) row space: its elements
        // start at row * d, its scale (int8 pools) is scale[row]
        const long long row =
            (static_cast<long long>(page) * K + kh) * ps + (t % ps);
        const long long off = row * d;
        float ks = 1.f;
        if constexpr (Load::kScaled) ks = kscale[row];
        if (lane == 0) {
          row_id[r] = row;
          if constexpr (Load::kScaled) vs_sh[r] = vscale[row];
        }
        float kf[DC];
#pragma unroll
        for (int i = 0; i < DC; ++i) {
          const int c = lane + 32 * i;
          float x = c < d ? Load::get(kpool, off + c) : 0.f;
          if constexpr (Load::kScaled) x *= ks;
          kf[i] = x;
        }
        for (int g = 0; g < G; ++g) {
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
        for (int g = 0; g < G; ++g) w_sh[g * kTile + r] = kNegInf;
      }
    }
    __syncthreads();
    // online softmax: warp w handles heads w, w + 8, ...; lane = row
    for (int g = warp; g < G; g += kWarps) {
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
      if (idx < G * d) {
        const int g = idx / d, c = idx - g * d;
        float a = acc[j] * c_sh[g];
        const float* w = w_sh + g * kTile;
        for (int r = 0; r < n; ++r) {
          float x = Load::get(vpool, row_id[r] * d + c);
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
    if (idx < G * d) {
      const int g = idx / d, c = idx - g * d;
      const size_t oi = (static_cast<size_t>(b) * H + kh * G + g) * d + c;
      const float o = acc[j] / fmaxf(l_sh[g], 1e-30f);
      if (q_bf16)
        static_cast<__nv_bfloat16*>(out)[oi] = __float2bfloat16(o);
      else
        static_cast<float*>(out)[oi] = o;
    }
  }
}

struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *table, *lengths;
  void* out;
  int B, H, K, d, ps, P, N;
  float scale;
  int q_dtype;
  cudaStream_t stream;
};

template <typename Load>
cudaError_t launch(const Args& a) {
  if (a.q_dtype != kF32 && a.q_dtype != kBF16) return cudaErrorInvalidValue;
  const int G = a.H / a.K;
  if (G * a.d > kThreads * kMaxAcc || a.d > 256) return cudaErrorInvalidValue;
  const dim3 grid(a.K, a.B);
  const size_t smem = kTile * sizeof(long long) +
                      (kTile + G * a.d + G * kTile + 3 * G) * sizeof(float);
  using E = typename Load::Elem;
  const E* kpp = static_cast<const E*>(a.kp);
  const E* vpp = static_cast<const E*>(a.vp);
  const bool q_bf16 = a.q_dtype == kBF16;
  // head dims up to 64, 128 and 256: lanes past d are masked
#define TRAPTI_PAGED(DC)                                                    \
  paged_decode_kernel<Load, DC><<<grid, kThreads, smem, a.stream>>>(        \
      a.q, kpp, vpp, a.ks, a.vs, a.table, a.lengths, a.out, a.H, a.K, a.d,  \
      a.ps, a.P, a.N, a.scale, q_bf16)
  if (a.d <= 64) TRAPTI_PAGED(2);
  else if (a.d <= 128) TRAPTI_PAGED(4);
  else TRAPTI_PAGED(8);
#undef TRAPTI_PAGED
  return cudaGetLastError();
}

}  // namespace

// q: (B, H, d) float32 (q_dtype 0) or bfloat16 (1); kp, vp: (N, K, ps, d)
// float32 (pool_dtype 0), bfloat16 (1), float16 (2) or fp8 E4M3 codes (3);
// table: (B, P) int32; lengths: (B,) int32; out: (B, H, d) in q's type; all
// contiguous.
TRAPTI_EXPORT int paged_gqa_decode_fwd(const void* q, const void* kp,
                                       const void* vp, const void* table,
                                       const void* lengths, void* out, int B,
                                       int H, int K, int d, int ps, int P,
                                       int N, float scale, int q_dtype,
                                       int pool_dtype, void* stream) {
  const Args a{q, kp, vp, nullptr, nullptr,
               static_cast<const int*>(table),
               static_cast<const int*>(lengths), out, B, H, K, d, ps, P, N,
               scale, q_dtype, static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (pool_dtype == kF32) err = launch<LoadFloat<float>>(a);
  else if (pool_dtype == kBF16) err = launch<LoadFloat<__nv_bfloat16>>(a);
  else if (pool_dtype == kF16) err = launch<LoadFloat<__half>>(a);
  else if (pool_dtype == kE4M3) err = launch<LoadE4M3>(a);
  return static_cast<int>(err);
}

// As paged_gqa_decode_fwd with int8 pools kp, vp (N, K, ps, d) and their
// per-row float32 scales ks, vs (N, K, ps).
TRAPTI_EXPORT int paged_gqa_decode_quant_fwd(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* lengths, void* out, int B,
    int H, int K, int d, int ps, int P, int N, float scale, int q_dtype,
    void* stream) {
  const Args a{q, kp, vp, static_cast<const float*>(ks),
               static_cast<const float*>(vs), static_cast<const int*>(table),
               static_cast<const int*>(lengths), out, B, H, K, d, ps, P, N,
               scale, q_dtype, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch<LoadInt8>(a));
}
