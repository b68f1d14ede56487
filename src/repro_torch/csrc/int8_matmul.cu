// int8 x int8 -> int32 matmul with per-row / per-column float32 scales.
//
// Replaces repro/kernels/int8_matmul/kernel.py int8_matmul_kernel
// (_int8_mm_kernel): out[m, n] = (float(acc[m, n]) * sx[m]) * sw[n] with
// acc = sum_k x[m, k] * w[k, n] accumulated exactly in int32
// (|acc| <= K * 127^2 < 2^31 for K < 133,000). The epilogue multiplies in
// the reference's order with round-to-nearest and no fused multiply-add, so
// the output equals the plain version's bit for bit. Unlike the Pallas
// kernel, which asserts that M, N and K divide its 128 blocks, every edge
// is masked: token counts such as M = 499 and any N, K work.
//
// Bound on the H100: 2*M*N*K int8 operations against M*K + K*N bytes in and
// 4*M*N bytes out; at the int8 FFN's shapes (M 499, 1536 x 8960) the bytes
// (~32 MB, ~9.7 us at 3.35 TB/s) and the operations (~6.9 us at the data
// sheet's 1,979 dense int8 TOP/s) are close. This first kernel runs on the
// CUDA cores, not the tensor cores:
//   * one block of 256 threads per 64 x 64 output tile, each thread a 4 x 4
//     sub-tile of int32 accumulators in registers;
//   * the K axis in steps of 32: the block stages the x tile (64 x 32) and
//     the w tile (32 x 64, transposed) in shared memory, four k values
//     packed in one 32-bit word, zero outside M, N and K;
//   * each thread takes __dp4a (four int8 products summed into an int32)
//     over the packed words. Rows are padded to 9 words so the 16 column
//     words a warp reads fall in distinct banks.
// mma.sync / wgmma int8 tiles are later work.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kTM = 4, kTN = 4;               // outputs per thread
constexpr int kWords = kBK / 4;               // packed words per tile row
constexpr int kPad = kWords + 1;

// kRaw: write the int32 accumulators themselves (acc_out) instead of the
// scaled float32 output, so a check can compare the accumulation exactly.
template <bool kRaw>
__global__ void __launch_bounds__(kThreads)
int8_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ sx, const float* __restrict__ sw,
               float* __restrict__ out, int* __restrict__ acc_out, int M,
               int N, int K) {
  __shared__ int xs[kBM][kPad];   // xs[r][j] packs x[m0 + r, k0 + 4j .. +3]
  __shared__ int ws[kBN][kPad];   // ws[c][j] packs w[k0 + 4j .. +3, n0 + c]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // rows ty + 16 i, cols tx + 16 j
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kWords; i += kThreads) {
      const int r = i / kWords, j = i - r * kWords;
      const int m = m0 + r;
      unsigned int packed = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + 4 * j + e;
        const int v = (m < M && k < K) ? x[static_cast<long long>(m) * K + k]
                                       : 0;
        packed |= (static_cast<unsigned int>(v) & 0xFFu) << (8 * e);
      }
      xs[r][j] = static_cast<int>(packed);
    }
    // consecutive threads take consecutive columns: coalesced reads of w
    for (int i = tid; i < kBN * kWords; i += kThreads) {
      const int j = i / kBN, c = i - j * kBN;
      const int n = n0 + c;
      unsigned int packed = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + 4 * j + e;
        const int v = (n < N && k < K) ? w[static_cast<long long>(k) * N + n]
                                       : 0;
        packed |= (static_cast<unsigned int>(v) & 0xFFu) << (8 * e);
      }
      ws[c][j] = static_cast<int>(packed);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      int a[kTM], bw[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[ty + 16 * i][j];
#pragma unroll
      for (int t = 0; t < kTN; ++t) bw[t] = ws[tx + 16 * t][j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int t = 0; t < kTN; ++t) acc[i][t] = __dp4a(a[i], bw[t], acc[i][t]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int t = 0; t < kTN; ++t) {
      const int n = n0 + tx + 16 * t;
      if (n >= N) continue;
      const long long o = static_cast<long long>(m) * N + n;
      if constexpr (kRaw) {
        acc_out[o] = acc[i][t];
      } else {
        out[o] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][t]), sx[m]),
                           sw[n]);
      }
    }
  }
}

}  // namespace

// x: (M, K) int8; w: (K, N) int8; sx: (M,) float32; sw: (N,) float32; all
// contiguous. Writes out (M, N) float32, or, when out is null, the int32
// accumulators into acc_out (M, N) (sx, sw unused).
TRAPTI_EXPORT int int8_matmul_fwd(const void* x, const void* w,
                                  const void* sx, const void* sw, void* out,
                                  void* acc_out, int M, int N, int K,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (out == nullptr && acc_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  if (out != nullptr)
    int8_mm_kernel<false><<<grid, kThreads, 0, s>>>(
        xp, wp, sxp, swp, static_cast<float*>(out), nullptr, M, N, K);
  else
    int8_mm_kernel<true><<<grid, kThreads, 0, s>>>(
        xp, wp, sxp, swp, nullptr, static_cast<int*>(acc_out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
