"""The split-context arithmetic of the paged decode and verify kernels on
float and fp8 pools (`paged_gqa_decode_split_ref`,
`paged_gqa_verify_split_ref`: the yardsticks `csrc/decode_attention.cuh`
is held to on the card) against the JAX reference on the CPU.

Inputs are drawn with numpy from fixed seeds and handed to both packages:
float32 pools, their bfloat16 rounding, or fp8 E4M3 codes cast by each
package. Tolerance: 2e-5 absolute in float32 (the same function with the
softmax split and summed in another order), against the reference's
`backend="ref"` path, its Pallas kernels in interpret mode and the port's
unsplit plain versions. Tables span several 64-row splits, with lengths on
both sides of split edges, a one-row slot and a null-page slot. Verify row
v is the decode mirror at base + v + 1, and a slot's row does not depend
on the batch it shares, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_gqa_decode import paged_gqa_decode as jax_decode
from repro.kernels.paged_gqa_verify import paged_gqa_verify as jax_verify
from repro.kernels.quant import to_fp8_codes as jax_fp8_codes
from repro_torch.kernels.paged_gqa_decode import (paged_gqa_decode_ref,
                                                  paged_gqa_decode_split_ref)
from repro_torch.kernels.paged_gqa_verify import (paged_gqa_verify_ref,
                                                  paged_gqa_verify_split_ref)
from repro_torch.kernels.quant import to_fp8_codes

ATOL = 2e-5
PAGE, PAGES = 8, 20   # a 160-row table: splits of 64, 64 and 32 rows
# decode: the null-page slot, a one-row slot, both sides of the first and
# second split edges, a partial last page, a full table
LENGTHS = (1, 1, 63, 64, 65, 128, 129, 157, 160)
# verify (V 4): window rows on both sides of the split edges at 64 and 128
BASES = (0, 0, 60, 61, 63, 64, 125, 126, 156)
V = 4


def _case(seed, H, K, d, lengths, window=0):
    """float32 pools and a table covering lengths + window rows per slot;
    slot 0 points its whole table at the null page 0, every other slot at
    distinct pages. The query has `window` rows per slot when given."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    need = [-(-(n + window) // PAGE) for n in lengths]
    N = 1 + sum(need[1:])
    shape = (B, window, H, d) if window else (B, H, d)
    q = rng.standard_normal(shape).astype(np.float32)
    kp, vp = rng.standard_normal((2, N, K, PAGE, d)).astype(np.float32)
    table = np.zeros((B, PAGES), np.int32)
    perm = list(rng.permutation(np.arange(1, N)))
    for b in range(1, B):
        for j in range(need[b]):
            table[b, j] = perm.pop()
    return q, kp, vp, table, np.asarray(lengths, np.int32)


def _pools(kp, vp, pools):
    """The same pools for JAX and for the port: float32, rounded to
    bfloat16, or cast to fp8 E4M3 codes by each package."""
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp), torch.from_numpy(vp)
    if pools == "bf16":
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.bfloat16(), tv.bfloat16()
    elif pools == "fp8":
        jk, jv = jax_fp8_codes(jk), jax_fp8_codes(jv)
        tk, tv = to_fp8_codes(tk), to_fp8_codes(tv)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    return (jk, jv), (tk, tv)


def _args(case, pools):
    q, kp, vp, table, lens = case
    (jk, jv), (tk, tv) = _pools(kp, vp, pools)
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(lens))
    targs = (torch.from_numpy(q), tk, tv, torch.from_numpy(table),
             torch.from_numpy(lens))
    return jargs, targs


@pytest.mark.parametrize("pools", ["f32", "bf16", "fp8"])
@pytest.mark.parametrize("H,K,d", [(12, 2, 16), (4, 4, 32), (6, 1, 16)])
def test_decode_split_mirror_matches_jax(H, K, d, pools):
    """GQA groups of 6, 1 (MHA) and 6 under one KV head."""
    jargs, targs = _args(_case(H * 10 + K + d, H, K, d, LENGTHS), pools)
    got = paged_gqa_decode_split_ref(*targs).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_decode(
        *jargs, backend="ref")), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, paged_gqa_decode_ref(*targs).numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("pools", ["f32", "bf16", "fp8"])
@pytest.mark.parametrize("H,K,d", [(12, 2, 16), (4, 4, 32)])
def test_verify_split_mirror_matches_jax(H, K, d, pools):
    jargs, targs = _args(_case(H + K + d, H, K, d, BASES, V), pools)
    got = paged_gqa_verify_split_ref(*targs)
    assert got.shape == targs[0].shape
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_verify(
        *jargs, backend="ref")), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(),
                               paged_gqa_verify_ref(*targs).numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("pools", ["f32", "bf16", "fp8"])
def test_split_mirrors_match_interpret_mode_pallas(pools):
    """Both mirrors against the reference's Pallas kernels in interpret
    mode, as `tests/test_torch_spec.py` runs the verify kernel."""
    jargs, targs = _args(_case(5, 4, 2, 16, (1, 65, 160)), pools)
    np.testing.assert_allclose(
        paged_gqa_decode_split_ref(*targs).numpy(),
        np.asarray(jax_decode(*jargs, backend="interpret")), atol=ATOL,
        rtol=0)
    jargs, targs = _args(_case(6, 4, 2, 16, (0, 62, 156), V), pools)
    np.testing.assert_allclose(
        paged_gqa_verify_split_ref(*targs).numpy(),
        np.asarray(jax_verify(*jargs, backend="interpret")), atol=ATOL,
        rtol=0)


@pytest.mark.parametrize("pools", ["f32", "bf16", "fp8"])
def test_verify_mirror_rows_are_decode_mirror_rows(pools):
    """Row v of the verify mirror is the decode mirror at base + v + 1,
    bit for bit, in float32 and with a bf16 query."""
    q, kp, vp, table, base = _args(_case(7, 12, 2, 16, BASES, V), pools)[1]
    for qd in (torch.float32, torch.bfloat16):
        out = paged_gqa_verify_split_ref(q.to(qd), kp, vp, table, base)
        assert out.dtype == qd
        for v in range(V):
            assert torch.equal(out[:, v], paged_gqa_decode_split_ref(
                q[:, v].to(qd), kp, vp, table, base + v + 1)), v


@pytest.mark.parametrize("pools", ["f32", "fp8"])
def test_split_mirrors_are_batch_invariant(pools):
    """Each slot alone gives its row of the batch bit for bit, in float32
    and with a bf16 query (whose output is bf16)."""
    for mirror, lengths, window in ((paged_gqa_decode_split_ref, LENGTHS, 0),
                                    (paged_gqa_verify_split_ref, BASES, V)):
        q, kp, vp, table, lens = _args(_case(3, 12, 2, 16, lengths, window),
                                       pools)[1]
        for qd in (torch.float32, torch.bfloat16):
            batch = mirror(q.to(qd), kp, vp, table, lens)
            for b in range(len(lens)):
                one = mirror(q[b:b + 1].to(qd), kp, vp, table[b:b + 1],
                             lens[b:b + 1])
                assert torch.equal(one, batch[b:b + 1]), b


@pytest.mark.parametrize("split_rows", [16, 64, 256])
def test_split_mirrors_match_unsplit_plain_versions(split_rows):
    """Splits of 16 rows (ten), 64 (the kernels') or 256 (one, wider than
    the table) give the unsplit plain versions' function."""
    case = _args(_case(11, 12, 2, 16, LENGTHS), "f32")[1]
    np.testing.assert_allclose(
        paged_gqa_decode_split_ref(*case, split_rows=split_rows).numpy(),
        paged_gqa_decode_ref(*case).numpy(), atol=ATOL, rtol=0)
    case = _args(_case(12, 12, 2, 16, BASES, V), "f32")[1]
    np.testing.assert_allclose(
        paged_gqa_verify_split_ref(*case, split_rows=split_rows).numpy(),
        paged_gqa_verify_ref(*case).numpy(), atol=ATOL, rtol=0)
