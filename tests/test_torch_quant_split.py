"""The int8 paged decode kernel's split-context arithmetic
(`paged_gqa_decode_quant_split_ref`, the yardstick `csrc/decode_attention.cuh`
is held to on the card) against the JAX reference on the CPU.

Inputs are drawn with numpy from fixed seeds and quantized per row by the
JAX package; both sides get the same int8 pools, scales, page table and
lengths. Tolerance: 2e-5 absolute in float32 (the same function with the
scales and the softmax summed in another order), against the reference's
page-by-page mirror, its `backend="ref"` path and, on one case, its Pallas
kernel in interpret mode. Tables span several 64-row splits, with lengths
on both sides of split edges, a one-row slot and a null-page slot; a slot's
row does not depend on the batch it shares, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as jq
from repro.kernels.paged_gqa_decode import \
    paged_gqa_decode_quant as jax_paged_quant
from repro.kernels.paged_gqa_decode.ref import \
    paged_gqa_decode_quant_mirror_ref as jax_mirror
from repro_torch.kernels.paged_gqa_decode import (
    paged_gqa_decode_quant, paged_gqa_decode_quant_split_ref)

ATOL = 2e-5
PAGE, PAGES = 8, 20   # a 160-row table: splits of 64, 64 and 32 rows
# the null-page slot, a one-row slot, both sides of the first and second
# split edges, a partial last page, a full table
LENGTHS = (1, 1, 63, 64, 65, 128, 129, 157, 160)


def _case(seed, H, K, d=16, lengths=LENGTHS):
    """int8 pools quantized per row by the JAX package; slot 0 points its
    whole table at the null page 0, every other slot at distinct pages."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    N = 1 + sum(-(-n // PAGE) for n in lengths[1:])
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kf, vf = rng.standard_normal((2, N, K, PAGE, d)).astype(np.float32)
    table = np.zeros((B, PAGES), np.int32)
    perm = list(rng.permutation(np.arange(1, N)))
    for b, n in enumerate(lengths[1:], start=1):
        for j in range(-(-n // PAGE)):
            table[b, j] = perm.pop()
    kp, ks = jq.quantize_page_rows(jnp.asarray(kf))
    vp, vs = jq.quantize_page_rows(jnp.asarray(vf))
    return [np.array(a) for a in (q, kp, vp, ks, vs, table,
                                  np.asarray(lengths, np.int32))]


@pytest.mark.parametrize("H,K,d", [(12, 2, 16), (4, 4, 32), (6, 1, 16),
                                   (8, 2, 64)])
def test_split_mirror_matches_jax(H, K, d):
    """GQA groups of 6, 1 (MHA), 6 under one KV head, 4 at head dim 64."""
    case = _case(H * 10 + K + d, H, K, d)
    jcase = list(map(jnp.asarray, case))
    tcase = list(map(torch.from_numpy, case))
    got = paged_gqa_decode_quant_split_ref(*tcase).numpy()
    for want in (jax_mirror(*jcase),
                 jax_paged_quant(*jcase, backend="ref")):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    # the port's CPU path (its vectorised plain version) agrees too
    np.testing.assert_allclose(paged_gqa_decode_quant(*tcase).numpy(), got,
                               atol=ATOL, rtol=0)


def test_split_mirror_matches_interpret_mode_pallas():
    case = _case(5, 4, 2, 16, lengths=(1, 65, 160))
    want = jax_paged_quant(*map(jnp.asarray, case), backend="interpret")
    got = paged_gqa_decode_quant_split_ref(*map(torch.from_numpy, case))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("split_rows", [32, 48])
def test_split_mirror_does_not_depend_on_split_rows_beyond_tolerance(
        split_rows):
    """Splits of 32 rows (five) or 48 (four, the last ragged) give the
    same function as the kernel's SPLIT_ROWS."""
    case = list(map(torch.from_numpy, _case(11, 12, 2)))
    base = paged_gqa_decode_quant_split_ref(*case)
    other = paged_gqa_decode_quant_split_ref(*case, split_rows=split_rows)
    np.testing.assert_allclose(other.numpy(), base.numpy(), atol=ATOL,
                               rtol=0)


def test_split_mirror_is_batch_invariant_and_bf16_query():
    """Each slot alone gives its row of the batch bit for bit, in float32
    and with a bf16 query (whose output is bf16)."""
    q, kp, vp, ks, vs, table, lens = map(torch.from_numpy, _case(3, 12, 2))
    for qd in (torch.float32, torch.bfloat16):
        batch = paged_gqa_decode_quant_split_ref(q.to(qd), kp, vp, ks, vs,
                                                 table, lens)
        assert batch.dtype == qd
        for b in range(len(lens)):
            one = paged_gqa_decode_quant_split_ref(
                q[b:b + 1].to(qd), kp, vp, ks, vs, table[b:b + 1],
                lens[b:b + 1])
            assert torch.equal(one, batch[b:b + 1]), b
