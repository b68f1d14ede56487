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
// addressing: a load policy turns 16 bytes of a pool into float32 (and
// says whether rows carry a scale). The query's type is a run-time
// argument: q is read once and the output written once per block, outside
// the loops, so templating on it would only double the build.
//
// Bound on the H100: each call reads every resident K and V row once
// (2 * lengths * K * d elements per slot, plus 2 scales per row for int8)
// and does about 4 * H * d flops per row, a few flops per byte, so it is
// bound by bytes. The TPU kernel walked a slot's pages in order on one
// core; here ceil(P * ps / 64) blocks per (KV head, slot) each copy their
// 64 rows (codes, and scales for int8) to shared memory, then a merge
// launch combines them (144 + 16 blocks for dsr1d at 8 slots and a
// 576-row table), so that enough blocks fill the card. The split count
// comes from the table's width, not the lengths, which live on the
// device: no host sync, and a slot's result does not depend on the batch.
// Each block reads the page-table entries of its rows itself (the TPU
// scalar-prefetched them). Verification (kernel 6) runs the same kernel
// instances with V window rows, row for row.
#include "decode_attention.cuh"

// q: (B, H, d) float32 (q_dtype 0) or bfloat16 (1); kp, vp: (N, K, ps, d)
// float32 (pool_dtype 0), bfloat16 (1), float16 (2) or fp8 E4M3 codes (3),
// d a multiple of 16 bytes' worth of elements and every pool 16-byte
// aligned; table: (B, P) int32; lengths: (B,) int32; out: (B, H, d) in q's
// type; all contiguous; workspace: B * K * nsplit * (H / K) * (d + 2)
// floats, where nsplit must be ceil(P * ps / 64).
TRAPTI_EXPORT int paged_gqa_decode_fwd(const void* q, const void* kp,
                                       const void* vp, const void* table,
                                       const void* lengths, void* out,
                                       void* workspace, int B, int H, int K,
                                       int d, int ps, int P, int N,
                                       float scale, int q_dtype,
                                       int pool_dtype, int nsplit,
                                       void* stream) {
  const PagedRows rows{static_cast<const int*>(table), ps, P, N, K};
  return static_cast<int>(launch_paged_split(
      q, kp, vp, rows, static_cast<const int*>(lengths),
      static_cast<float*>(workspace), out, B, H, K, d, 1, 0, nsplit, scale,
      q_dtype, pool_dtype, static_cast<cudaStream_t>(stream)));
}

// As paged_gqa_decode_fwd with int8 pools kp, vp (N, K, ps, d), d a
// multiple of 16 and every pool 16-byte aligned, and their per-row float32
// scales ks, vs (N, K, ps).
TRAPTI_EXPORT int paged_gqa_decode_quant_fwd(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* lengths, void* out,
    void* workspace, int B, int H, int K, int d, int ps, int P, int N,
    float scale, int q_dtype, int nsplit, void* stream) {
  if (nsplit != (P * ps + kSplitRows - 1) / kSplitRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedRows rows{static_cast<const int*>(table), ps, P, N, K};
  return static_cast<int>(launch_decode_split<LoadInt8, false>(
      q, kp, vp, static_cast<const float*>(ks), static_cast<const float*>(vs),
      rows, static_cast<const int*>(lengths), static_cast<float*>(workspace),
      out, B, H, K, d, 1, 0, nsplit, scale, q_dtype,
      static_cast<cudaStream_t>(stream)));
}
