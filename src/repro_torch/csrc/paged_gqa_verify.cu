// Paged GQA speculative verification for Hopper, over float and fp8 pools.
//
// Replaces the Pallas paged_gqa_verify_kernel (_paged_verify_kernel) of
// repro/kernels/paged_gqa_verify/kernel.py: each slot carries V = k + 1
// query rows (the pending token and the k drafted candidates) at absolute
// positions base_lens[b] + v, all attending the slot's pages through its
// page-table row; row v attends base_lens[b] + v + 1 tokens. Pools hold
// float32, bfloat16, float16 or fp8 E4M3 codes, read as float32 whatever
// the query's type, as kernel 1's.
//
// It is kernel 1 (paged_gqa_decode.cu) with R = V * group query rows per
// (KV head, slot, split) block instead of group, laid out window-major
// (row v * group + g, as the reference lays them out), and a per-row
// horizon: decode_attention.cuh's kernels with len_add = 1. The V rows
// share one copy of each split's K/V rows, which is the point of the
// batched verify: scoring k + 1 candidates reads the resident rows once,
// not k + 1 times. Each window row's sums stop at its own horizon, and the
// splits and their slicing are kernel 1's, so row v computes, operation
// for operation, what kernel 1 computes at length base_lens[b] + v + 1.
//
// Bound on the H100: bytes, as kernel 1 (each resident row read once per
// call; about 4 * V * H * d flops per row). A block holds at most 64 query
// rows and 4096 query elements (rows x head_dim, in its threads'
// registers); a KV head with more runs them in row chunks across the grid,
// each re-reading the split's K/V rows from L2: k = 3 at dsr1d (4 x 6 x
// 128 = 3072 elements) takes one block per (KV head, slot, split),
// granite-34b's MQA group of 48 (4 x 48 = 192 rows at d 128) six.
#include "decode_attention.cuh"

// q: (B, V, H, d) float32 (q_dtype 0) or bfloat16 (1); kp, vp: (N, K, ps, d)
// float32 (pool_dtype 0), bfloat16 (1), float16 (2) or fp8 E4M3 codes (3),
// d a multiple of 16 bytes' worth of elements and every pool 16-byte
// aligned; table: (B, P) int32; base_lens: (B,) int32 context lengths
// before the window; out: (B, V, H, d) in q's type; all contiguous;
// workspace: B * K * nsplit * V * (H / K) * (d + 2) floats, where nsplit
// must be ceil(P * ps / 64).
TRAPTI_EXPORT int paged_gqa_verify_fwd(const void* q, const void* kp,
                                       const void* vp, const void* table,
                                       const void* base_lens, void* out,
                                       void* workspace, int B, int V, int H,
                                       int K, int d, int ps, int P, int N,
                                       float scale, int q_dtype,
                                       int pool_dtype, int nsplit,
                                       void* stream) {
  const PagedRows rows{static_cast<const int*>(table), ps, P, N, K};
  return static_cast<int>(launch_paged_split(
      q, kp, vp, rows, static_cast<const int*>(base_lens),
      static_cast<float*>(workspace), out, B, H, K, d, V, 1, nsplit, scale,
      q_dtype, pool_dtype, static_cast<cudaStream_t>(stream)));
}
