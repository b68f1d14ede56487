// Dense-cache GQA decode attention for Hopper.
//
// Replaces the Pallas gqa_decode_kernel (_decode_kernel) of
// repro/kernels/gqa_decode/kernel.py: one query token per sequence against
// a dense K/V cache (B, K, T, d); positions >= lengths[b] are masked, and
// lengths past T attend all T rows. Caches hold float32, bfloat16 or
// float16, read as float32 whatever the query's type.
//
// It is kernel 1's control flow (decode_attention.cuh, V = 1) with row t of
// (sequence b, KV head kh) at element b * sb + kh * sk + t * st in place of
// the page-table lookup. The strides are the caller's: the port's dense
// cache is (B, T, K, d), and its decode step passes the (B, K, T, d) view
// k.transpose(1, 2) without a copy, so rows of one KV head lie K * d
// elements apart. Only d must be contiguous, and K and V share strides.
//
// Bound on the H100: bytes (each valid K and V row read once; about
// 4 * H * d flops per row). One block per (KV head, sequence): 16 blocks
// for dsr1d at batch 8, far from that bound; splitting the context across
// blocks is later work.
#include "decode_attention.cuh"

// q: (B, H, d) float32 (q_dtype 0) or bfloat16 (1), contiguous; k, v: the
// (B, K, T, d) caches as element strides sb, sk, st (d contiguous), float32
// (cache_dtype 0), bfloat16 (1) or float16 (2); lengths: (B,) int32;
// out: (B, H, d) in q's type, contiguous.
TRAPTI_EXPORT int gqa_decode_fwd(const void* q, const void* k, const void* v,
                                 const void* lengths, void* out, int B, int H,
                                 int K, int d, int T, long long sb,
                                 long long sk, long long st, float scale,
                                 int q_dtype, int cache_dtype, void* stream) {
  const StridedRows rows{sb, sk, st, T};
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define TRAPTI_DENSE(LOAD)                                                  \
  launch_decode_attention<LOAD>(q, k, v, nullptr, nullptr, rows, lens, out, \
                                B, H, K, d, 1, 0, scale, q_dtype, s)
  if (cache_dtype == kF32) err = TRAPTI_DENSE(LoadFloat<float>);
  else if (cache_dtype == kBF16) err = TRAPTI_DENSE(LoadFloat<__nv_bfloat16>);
  else if (cache_dtype == kF16) err = TRAPTI_DENSE(LoadFloat<__half>);
#undef TRAPTI_DENSE
  return static_cast<int>(err);
}
