// Causal prefill attention (GQA) for Hopper.
//
// Replaces repro/kernels/flash_attention/kernel.py flash_attention_kernel
// (_flash_kernel), and with it the jnp blocked_attention the reference
// prefill runs (repro/models/attention.py), which computes the same function.
//
// Layout: q (B, S, H, d), k/v (B, T, K, d), out (B, S, H, d), as the model
// produces them; query head h reads KV head h / (H / K). Query row s attends
// keys t <= s (no offset). float32 or bfloat16 in, float32 softmax and
// accumulators, output in the input dtype.
//
// Bound on the H100: at prefill lengths of hundreds of tokens the work is
// O(S^2 d) multiply-adds per head against O(S d) bytes, so it is bound by
// operations; at the tensor cores' bf16 rate it would take microseconds.
// This first version computes on the CUDA cores in float32 (wgmma/TMA are
// later work) and keeps the design simple:
//   * one block per (16-query-row tile, head, batch), four warps with four
//     query rows each; the query tile is scaled once into shared memory;
//   * the block walks KV tiles of 32 keys in a fixed order from key 0 up to
//     its last visible key (tiles above the causal diagonal are never
//     loaded), so a row's reduction order does not depend on the prompt
//     length; K and V tiles are staged in float32 shared memory with a
//     padded row stride (no bank conflicts when lane j reads key j);
//   * lane j scores key j for the warp's four rows; an online softmax keeps
//     m, l and the output accumulators in registers; masked scores are
//     -1e30 and contribute p = 0, the denominator is clamped at 1e-30, as in
//     the reference; ragged S is masked, never padded.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per KV tile (one per lane)
constexpr float kNegInf = -1.0e30f;

template <typename T, int DC>  // DC: head dims per lane, d <= 32 * DC
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int Tk,
                 int H, int K, int d, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;  // padded row stride of the K/V tiles
  float* q_sh = smem;               // kBQ * d
  float* k_sh = q_sh + kBQ * d;     // kBK * ld
  float* v_sh = k_sh + kBK * ld;    // kBK * ld

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < kBQ * d; i += kWarps * 32) {
    const int r = i / d, c = i - r * d, s = q0 + r;
    q_sh[i] = s < S ? to_f32(q[(static_cast<size_t>(b) * S + s) * H * d +
                               static_cast<size_t>(h) * d + c]) * scale
                    : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DC; ++i) acc[r][i] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = min(q_last + 1, Tk);  // keys beyond are above the diagonal
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q_sh is written)
    for (int i = tid; i < kBK * d; i += kWarps * 32) {
      const int j = i / d, c = i - j * d, t = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (t < Tk) {
        const size_t off = (static_cast<size_t>(b) * Tk + t) * K * d +
                           static_cast<size_t>(kh) * d + c;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      k_sh[j * ld + c] = kx;
      v_sh[j * ld + c] = vx;
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* krow = k_sh + lane * ld;
    const float* qrow = q_sh + warp * kRowsPerWarp * d;
    for (int c = 0; c < d; ++c) {
      const float kc = krow[c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] += qrow[r * d + c] * kc;
    }

    const int t = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qs = q0 + warp * kRowsPerWarp + r;
      const float sv = (t < Tk && t <= qs) ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = sv <= kNegInf / 2 ? 0.f : expf(sv - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DC; ++i) acc[r][i] *= corr;
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float* vrow = v_sh + j * ld;
#pragma unroll
        for (int i = 0; i < DC; ++i) {
          const int c = lane + 32 * i;
          if (c < d) acc[r][i] += pj * vrow[c];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qs = q0 + warp * kRowsPerWarp + r;
    if (qs >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = out + (static_cast<size_t>(b) * S + qs) * H * d +
              static_cast<size_t>(h) * d;
#pragma unroll
    for (int i = 0; i < DC; ++i) {
      const int c = lane + 32 * i;
      if (c < d) orow[c] = from_f32<T>(acc[r][i] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Tk, int H, int K, int d, float scale,
                   cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  const size_t smem = (kBQ * d + 2 * kBK * (d + 1)) * sizeof(float);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (d <= 32)
    flash_fwd_kernel<T, 1><<<grid, kWarps * 32, smem, stream>>>(qp, kp, vp, op, S, Tk, H, K, d, scale);
  else if (d <= 64)
    flash_fwd_kernel<T, 2><<<grid, kWarps * 32, smem, stream>>>(qp, kp, vp, op, S, Tk, H, K, d, scale);
  else if (d <= 128)
    flash_fwd_kernel<T, 4><<<grid, kWarps * 32, smem, stream>>>(qp, kp, vp, op, S, Tk, H, K, d, scale);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// q: (B, S, H, d); k, v: (B, T, K, d); out: (B, S, H, d); all contiguous,
// dtype 0 = float32, 1 = bfloat16; d <= 128; scale = 1/sqrt(d).
TRAPTI_EXPORT int flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int T, int H, int K, int d, float scale,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32)
    err = launch<float>(q, k, v, out, B, S, T, H, K, d, scale, s);
  else if (dtype == kBF16)
    err = launch<__nv_bfloat16>(q, k, v, out, B, S, T, H, K, d, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
