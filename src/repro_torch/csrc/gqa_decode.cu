// Dense-cache GQA decode attention for Hopper.
//
// Replaces the Pallas gqa_decode_kernel (_decode_kernel) of
// repro/kernels/gqa_decode/kernel.py: one query token per sequence against
// a dense K/V cache (B, K, T, d); positions >= lengths[b] are masked, and
// lengths past T attend all T rows. Caches hold float32, bfloat16 or
// float16, read as float32 whatever the query's type.
//
// Row t of (sequence b, KV head kh) lies at element b * sb + kh * sk + t * st
// (decode_attention.cuh, StridedRows). The strides are the caller's: the
// port's dense cache is (B, T, K, d), and its decode step passes the
// (B, K, T, d) view k.transpose(1, 2) without a copy, so rows of one KV head
// lie K * d elements apart. Only d must be contiguous, and K and V share
// strides.
//
// Bound on the H100: bytes (each valid K and V row read once; about
// 4 * H * d flops per row). It runs the template's split kernels: a
// grid of (KV head, sequence, ceil(T / 64)) blocks, each over 64 fixed
// cache rows, then a merge launch of one thread per output element (160 +
// 48 blocks for dsr1d at batch 8 and T 640, 20 + 6 at batch 1, where one
// block per KV head and sequence ran 16 and 2). Rows are copied in 16-byte
// pieces, so every row must start 16-byte aligned: the wrapper copies a
// view that does not.
#include "decode_attention.cuh"

// q: (B, H, d) float32 (q_dtype 0) or bfloat16 (1), contiguous; k, v: the
// (B, K, T, d) caches as element strides sb, sk, st (d contiguous, every
// row 16-byte aligned), float32 (cache_dtype 0), bfloat16 (1) or float16
// (2); lengths: (B,) int32; out: (B, H, d) in q's type, contiguous;
// workspace: B * K * nsplit * (H / K) * (d + 2) floats, where nsplit must
// be ceil(T / 64).
TRAPTI_EXPORT int gqa_decode_fwd(const void* q, const void* k, const void* v,
                                 const void* lengths, void* out,
                                 void* workspace, int B, int H, int K, int d,
                                 int T, long long sb, long long sk,
                                 long long st, float scale, int q_dtype,
                                 int cache_dtype, int nsplit, void* stream) {
  const StridedRows rows{sb, sk, st, T};
  const int* lens = static_cast<const int*>(lengths);
  float* part = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nsplit != (T + kSplitRows - 1) / kSplitRows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
#define TRAPTI_DENSE(LOAD)                                                \
  launch_decode_split<LOAD, false>(q, k, v, nullptr, nullptr, rows, lens, \
                                   part, out, B, H, K, d, 1, 0, nsplit,   \
                                   scale, q_dtype, s)
  if (cache_dtype == kF32) err = TRAPTI_DENSE(LoadFloat<float>);
  else if (cache_dtype == kBF16) err = TRAPTI_DENSE(LoadFloat<__nv_bfloat16>);
  else if (cache_dtype == kF16) err = TRAPTI_DENSE(LoadFloat<__half>);
#undef TRAPTI_DENSE
  return static_cast<int>(err);
}
