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
//     function on int8 pools, each row carrying a float32 scale (pools
//     (N, K, ps) of scales, reached through the same page-table
//     indirection as the row). Entry point paged_gqa_decode_quant_fwd.
// Both run decode_attention.cuh with one window row (V = 1) and page-table
// addressing: a load policy turns a pool element into float32 (and says
// whether rows carry a scale). The query's type is a run-time argument: q
// is read once and the output written once per block, outside the loops,
// so templating on it would only double the build.
//
// Bound on the H100: each call reads every resident K and V row once
// (2 * lengths * K * d elements per slot, plus 2 scales per row for int8)
// and does about 4 * H * d flops per row, a few flops per byte, so it is
// bound by bytes. Each block reads the page-table entries of its rows
// itself (the TPU scalar-prefetched them).
//   * Float and fp8 pools take the unsplit path: one block per (KV head,
//     slot) walks the context in tiles of 32 rows up to lengths[b]
//     (clamped to the table, so a slot that points at the null page 0
//     reads only in-bounds rows), the GQA group sharing each row load.
//     Only 16 blocks run for 8 slots x 2 KV heads (dsr1d), far from the
//     bound; verification (kernel 6) shares this path, row for row.
//   * int8 pools take the split-context path: ceil(P * ps / 64) blocks per
//     (KV head, slot), each copying its 64 rows' codes and scales to shared
//     memory, then a merge launch (144 + 16 blocks for dsr1d at 8 slots and
//     a 576-row table). The split count comes from the table's width, not
//     the lengths, which live on the device: no host sync, and a slot's
//     result does not depend on the batch.
#include "decode_attention.cuh"

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
  const PagedRows rows{static_cast<const int*>(table), ps, P, N, K};
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define TRAPTI_PAGED(LOAD)                                                  \
  launch_decode_attention<LOAD>(q, kp, vp, rows, lens, out, B, H, K, d, 1,  \
                                0, scale, q_dtype, s)
  if (pool_dtype == kF32) err = TRAPTI_PAGED(LoadFloat<float>);
  else if (pool_dtype == kBF16) err = TRAPTI_PAGED(LoadFloat<__nv_bfloat16>);
  else if (pool_dtype == kF16) err = TRAPTI_PAGED(LoadFloat<__half>);
  else if (pool_dtype == kE4M3) err = TRAPTI_PAGED(LoadE4M3);
#undef TRAPTI_PAGED
  return static_cast<int>(err);
}

// As paged_gqa_decode_fwd with int8 pools kp, vp (N, K, ps, d), d a
// multiple of 16 and every pool 16-byte aligned, and their per-row float32
// scales ks, vs (N, K, ps); workspace: B * K * nsplit * (H / K) * (d + 2)
// floats, where nsplit must be ceil(P * ps / 64).
TRAPTI_EXPORT int paged_gqa_decode_quant_fwd(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* lengths, void* out,
    void* workspace, int B, int H, int K, int d, int ps, int P, int N,
    float scale, int q_dtype, int nsplit, void* stream) {
  if (nsplit != (P * ps + kSplitRows - 1) / kSplitRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedRows rows{static_cast<const int*>(table), ps, P, N, K};
  return static_cast<int>(launch_decode_split<LoadInt8>(
      q, kp, vp, static_cast<const float*>(ks), static_cast<const float*>(vs),
      rows, static_cast<const int*>(lengths), static_cast<float*>(workspace),
      out, B, H, K, d, nsplit, scale, q_dtype,
      static_cast<cudaStream_t>(stream)));
}
