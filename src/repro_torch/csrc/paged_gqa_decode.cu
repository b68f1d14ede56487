// Paged GQA decode attention for Hopper.
//
// Replaces repro/kernels/paged_gqa_decode/kernel.py paged_gqa_decode_kernel
// (_paged_decode_kernel): one query token per slot against K/V rows that
// live in a global page pool (N, K, ps, d) and are reached through the
// slot's page-table row; positions >= lengths[b] (including the tail of a
// partially filled last page) are masked.
//
// Bound on the H100: each call reads every resident K and V row once
// (2 * lengths * K * d elements per slot) and does about 4 * H * d flops per
// row, a few flops per byte, so it is bound by bytes. The design:
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

template <typename T, int DC>  // DC: head dims per lane, d <= 32 * DC
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool, const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int H, int K, int d, int ps, int P, int N, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / K;
  long long* row_off = reinterpret_cast<long long*>(smem_raw);  // kTile
  float* q_sh = reinterpret_cast<float*>(row_off + kTile);      // G * d
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
    q_sh[i] = to_f32(q[(static_cast<size_t>(b) * H + kh * G + g) * d + c]) *
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
        const long long off =
            ((static_cast<long long>(page) * K + kh) * ps + (t % ps)) * d;
        if (lane == 0) row_off[r] = off;
        float kf[DC];
#pragma unroll
        for (int i = 0; i < DC; ++i) {
          const int c = lane + 32 * i;
          kf[i] = c < d ? to_f32(kpool[off + c]) : 0.f;
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
        for (int r = 0; r < n; ++r) a += w[r] * to_f32(vpool[row_off[r] + c]);
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
      out[(static_cast<size_t>(b) * H + kh * G + g) * d + c] =
          from_f32<T>(acc[j] / fmaxf(l_sh[g], 1e-30f));
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* table, const int* lengths, void* out, int B,
                   int H, int K, int d, int ps, int P, int N, float scale,
                   cudaStream_t stream) {
  const int G = H / K;
  if (G * d > kThreads * kMaxAcc || d > 256) return cudaErrorInvalidValue;
  const dim3 grid(K, B);
  const size_t smem =
      kTile * sizeof(long long) + (G * d + G * kTile + 3 * G) * sizeof(float);
  const T* qp = static_cast<const T*>(q);
  const T* kpp = static_cast<const T*>(kp);
  const T* vpp = static_cast<const T*>(vp);
  T* op = static_cast<T*>(out);
#define TRAPTI_PAGED(DC)                                                    \
  paged_decode_kernel<T, DC><<<grid, kThreads, smem, stream>>>(             \
      qp, kpp, vpp, table, lengths, op, H, K, d, ps, P, N, scale)
  if (d <= 32) TRAPTI_PAGED(1);
  else if (d <= 64) TRAPTI_PAGED(2);
  else if (d <= 128) TRAPTI_PAGED(4);
  else TRAPTI_PAGED(8);
#undef TRAPTI_PAGED
  return cudaGetLastError();
}

}  // namespace

// q: (B, H, d); kp, vp: (N, K, ps, d); table: (B, P) int32; lengths: (B,)
// int32; out: (B, H, d); all contiguous; dtype 0 = float32, 1 = bfloat16.
TRAPTI_EXPORT int paged_gqa_decode_fwd(const void* q, const void* kp,
                                       const void* vp, const void* table,
                                       const void* lengths, void* out, int B,
                                       int H, int K, int d, int ps, int P,
                                       int N, float scale, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tp = static_cast<const int*>(table);
  const int* lp = static_cast<const int*>(lengths);
  cudaError_t err;
  if (dtype == kF32)
    err = launch<float>(q, kp, vp, tp, lp, out, B, H, K, d, ps, P, N, scale, s);
  else if (dtype == kBF16)
    err = launch<__nv_bfloat16>(q, kp, vp, tp, lp, out, B, H, K, d, ps, P, N,
                                scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
