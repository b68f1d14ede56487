"""The split-context decode kernels at any GQA group: the split mirrors of
paged decode on float and fp8 pools (kernel 1), on int8 pools (kernel 5),
speculative verification (kernel 6) and dense decode (kernel 7) against the
JAX reference on the CPU, at granite-34b's MQA group of 48 (H48 K1 d128,
which `csrc/decode_attention.cuh` runs in row chunks), qwen2-7b's and
deepseek-coder-33b's group of 7 (H28 K4 d128) and tinyllama-1.1b's group
of 8 at d64 (H32 K4 d64).

Inputs are drawn with numpy from fixed seeds and handed to both packages:
float32 pools, their bfloat16 rounding, fp8 E4M3 codes cast by each
package, or int8 pools quantized per row by the JAX package. Tolerance: 2e-5
absolute in float32 (the same function with the softmax split and summed
in another order), against the reference's `backend="ref"` path and its
Pallas kernels in interpret mode. Tables span several 64-row splits, with
lengths on both sides of split edges, a one-row slot and a null-page slot.
Verify row v is the decode mirror at base + v + 1 and a slot's row does not
depend on the batch it shares, bit for bit. The wrappers' shape checks take
any group and still refuse a head dim above 256; on a card each kernel is
held to its mirror at granite's shape (`gpu` marker).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as jq
from repro.kernels.gqa_decode import gqa_decode as jax_dense
from repro.kernels.paged_gqa_decode import paged_gqa_decode as jax_decode
from repro.kernels.paged_gqa_decode import \
    paged_gqa_decode_quant as jax_quant
from repro.kernels.paged_gqa_verify import paged_gqa_verify as jax_verify
from repro.kernels.quant import to_fp8_codes as jax_fp8_codes
from repro_torch.kernels.flash_attention import MIRROR_ATOL, bf16_excess
from repro_torch.kernels.gqa_decode import (SPLIT_ROWS, gqa_decode,
                                            gqa_decode_split_ref)
from repro_torch.kernels.gqa_decode.ops import check_dense
from repro_torch.kernels.paged_gqa_decode import (
    paged_gqa_decode, paged_gqa_decode_quant, paged_gqa_decode_quant_split_ref,
    paged_gqa_decode_split_ref)
from repro_torch.kernels.paged_gqa_decode.ops import check_paged, check_split
from repro_torch.kernels.paged_gqa_verify import (paged_gqa_verify,
                                                  paged_gqa_verify_split_ref)
from repro_torch.kernels.paged_gqa_verify.ops import check_verify
from repro_torch.kernels.quant import to_fp8_codes

ATOL = 2e-5
PAGE, PAGES = 8, 20   # a 160-row table: splits of 64, 64 and 32 rows
# decode: the null-page slot, a one-row slot, both sides of the first and
# second split edges, a full table
LENGTHS = (1, 1, 63, 64, 65, 128, 129, 160)
# verify (V 4): window rows on both sides of the split edges at 64 and 128
BASES = (0, 0, 60, 61, 64, 125, 126, 156)
V = 4
GRANITE = (48, 1, 128)
# granite-34b; qwen2-7b and deepseek-coder-33b (group 7); tinyllama (d 64)
SHAPES = [GRANITE, (28, 4, 128), (32, 4, 64)]
DENSE_T = 160


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


def _args(case, pools):
    """The case for JAX and for the port, pools float32, rounded to
    bfloat16, or cast to fp8 E4M3 codes by each package."""
    q, kp, vp, table, lens = case
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp), torch.from_numpy(vp)
    if pools == "bf16":
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.bfloat16(), tv.bfloat16()
    elif pools == "fp8":
        jk, jv = jax_fp8_codes(jk), jax_fp8_codes(jv)
        tk, tv = to_fp8_codes(tk), to_fp8_codes(tv)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(lens))
    targs = (torch.from_numpy(q), tk, tv, torch.from_numpy(table),
             torch.from_numpy(lens))
    return jargs, targs


def _quant_case(seed, H, K, d, lengths=LENGTHS):
    """int8 pools and scales quantized per row by the JAX package."""
    q, kf, vf, table, lens = _case(seed, H, K, d, lengths)
    kp, ks = jq.quantize_page_rows(jnp.asarray(kf))
    vp, vs = jq.quantize_page_rows(jnp.asarray(vf))
    return [np.array(a) for a in (q, kp, vp, ks, vs, table, lens)]


def _dense_case(seed, H, K, d, lengths=LENGTHS + (DENSE_T + 9,)):
    """A (B, K, T, d) cache; lengths past T attend all T rows."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    k, v = rng.standard_normal((2, B, K, DENSE_T, d)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("pools", ["f32", "bf16", "fp8"])
@pytest.mark.parametrize("H,K,d", SHAPES)
def test_decode_split_mirror_matches_jax(H, K, d, pools):
    """Kernel 1's mirror against `backend="ref"`."""
    jargs, targs = _args(_case(H + K + d, H, K, d, LENGTHS), pools)
    got = paged_gqa_decode_split_ref(*targs).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_decode(
        *jargs, backend="ref")), atol=ATOL, rtol=0)


@pytest.mark.parametrize("H,K,d", SHAPES)
def test_quant_split_mirror_matches_jax(H, K, d):
    """Kernel 5's mirror against `backend="ref"`; the port's CPU path (its
    vectorised plain version) agrees too."""
    case = _quant_case(H * 3 + d, H, K, d)
    tcase = list(map(torch.from_numpy, case))
    got = paged_gqa_decode_quant_split_ref(*tcase).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_quant(
        *map(jnp.asarray, case), backend="ref")), atol=ATOL, rtol=0)
    np.testing.assert_allclose(paged_gqa_decode_quant(*tcase).numpy(), got,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("pools", ["bf16", "fp8"])
@pytest.mark.parametrize("H,K,d", SHAPES)
def test_verify_split_mirror_matches_jax(H, K, d, pools):
    """Kernel 6's mirror at V 4 (192 query rows per KV head at granite's
    shape) against `backend="ref"`."""
    jargs, targs = _args(_case(H * 5 + d, H, K, d, BASES, V), pools)
    got = paged_gqa_verify_split_ref(*targs)
    assert got.shape == targs[0].shape
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_verify(
        *jargs, backend="ref")), atol=ATOL, rtol=0)


@pytest.mark.parametrize("H,K,d", SHAPES)
def test_dense_split_mirror_matches_jax(H, K, d):
    """Kernel 7's mirror against `backend="ref"`, on a contiguous cache and
    on the decode step's (B, T, K, d) cache seen as (B, K, T, d)."""
    q, k, v, lens = _dense_case(H * 7 + d, H, K, d)
    want = np.asarray(jax_dense(*map(jnp.asarray, (q, k, v, lens)),
                                backend="ref"))
    args = list(map(torch.from_numpy, (q, k, v, lens)))
    got = gqa_decode_split_ref(*args, split_rows=SPLIT_ROWS).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    kt, vt = (torch.from_numpy(x.transpose(0, 2, 1, 3).copy()).transpose(1, 2)
              for x in (k, v))
    strided = gqa_decode_split_ref(args[0], kt, vt, args[3], SPLIT_ROWS)
    np.testing.assert_allclose(strided.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("pools", ["bf16", "fp8"])
def test_mirrors_match_interpret_mode_pallas_at_granite(pools):
    """Kernels 1, 6, 5 and 7's mirrors at the group of 48 against the
    reference's Pallas kernels in interpret mode (three slots: a one-row
    slot, one past the first split edge, a full table)."""
    H, K, d = GRANITE
    jargs, targs = _args(_case(5, H, K, d, (1, 65, 160)), pools)
    np.testing.assert_allclose(
        paged_gqa_decode_split_ref(*targs).numpy(),
        np.asarray(jax_decode(*jargs, backend="interpret")), atol=ATOL,
        rtol=0)
    jargs, targs = _args(_case(6, H, K, d, (0, 62, 156), V), pools)
    np.testing.assert_allclose(
        paged_gqa_verify_split_ref(*targs).numpy(),
        np.asarray(jax_verify(*jargs, backend="interpret")), atol=ATOL,
        rtol=0)
    if pools == "fp8":
        return
    case = _quant_case(8, H, K, d, (1, 65, 160))
    np.testing.assert_allclose(
        paged_gqa_decode_quant_split_ref(*map(torch.from_numpy, case)).numpy(),
        np.asarray(jax_quant(*map(jnp.asarray, case), backend="interpret")),
        atol=ATOL, rtol=0)
    q, k, v, lens = _dense_case(9, H, K, d, (1, 65, DENSE_T))
    np.testing.assert_allclose(
        gqa_decode_split_ref(*map(torch.from_numpy, (q, k, v, lens)),
                             split_rows=SPLIT_ROWS).numpy(),
        np.asarray(jax_dense(*map(jnp.asarray, (q, k, v, lens)),
                             backend="interpret", block_t=32)),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("pools", ["f32", "bf16", "fp8"])
def test_verify_rows_are_decode_rows_at_granite(pools):
    """Row v of the verify mirror is the decode mirror at base + v + 1, bit
    for bit, in float32 and with a bf16 query."""
    H, K, d = GRANITE
    q, kp, vp, table, base = _args(_case(7, H, K, d, BASES, V), pools)[1]
    for qd in (torch.float32, torch.bfloat16):
        out = paged_gqa_verify_split_ref(q.to(qd), kp, vp, table, base)
        for v in range(V):
            assert torch.equal(out[:, v], paged_gqa_decode_split_ref(
                q[:, v].to(qd), kp, vp, table, base + v + 1)), v


@pytest.mark.parametrize("mirror", ["decode", "verify", "quant", "dense"])
def test_mirrors_are_batch_invariant_at_granite(mirror):
    """Each slot alone gives its row of the batch bit for bit (the
    arguments of one slot: its query, table row and length; for the dense
    mirror also its cache)."""
    H, K, d = GRANITE
    if mirror == "quant":
        args = list(map(torch.from_numpy, _quant_case(3, H, K, d)))
        fn, per_slot = paged_gqa_decode_quant_split_ref, (0, 5, 6)
    elif mirror == "dense":
        args = list(map(torch.from_numpy, _dense_case(3, H, K, d)))
        fn, per_slot = gqa_decode_split_ref, (0, 1, 2, 3)
        args.append(SPLIT_ROWS)
    else:
        window = V if mirror == "verify" else 0
        args = list(_args(_case(3, H, K, d, BASES if window else LENGTHS,
                                window), "bf16")[1])
        fn = (paged_gqa_verify_split_ref if window
              else paged_gqa_decode_split_ref)
        per_slot = (0, 3, 4)
    batch = fn(*args)
    for b in range(args[0].shape[0]):
        one = fn(*[x[b:b + 1] if i in per_slot else x
                   for i, x in enumerate(args)])
        assert torch.equal(one, batch[b:b + 1]), b


def test_wrapper_checks_take_any_group_and_refuse_wide_heads():
    """The shape checks of kernels 1 and 5 (`check_paged`), 6
    (`check_verify`) and 7 (`check_dense`), called on CPU tensors: granite's
    group of 48, its 192 verify rows and a group of 64 at d 256 pass; a
    head dim of 512 is refused."""
    for H, K, d in (GRANITE, (64, 1, 256), (28, 4, 128)):
        q, kp, vp, table, lens = map(torch.from_numpy,
                                     _case(1, H, K, d, (1, 9)))
        dims, _, _ = check_paged("paged_gqa_decode", q, kp, vp, table, lens)
        assert dims[:4] == (2, H, K, d)
        check_split("paged_gqa_decode", kp, vp)
        qv = q[:, None].expand(2, V, H, d)
        dims, window, _, _ = check_verify(qv, kp, vp, table, lens)
        assert window == V and dims[1] // dims[2] * window == V * H // K
        kc = torch.zeros((2, K, 16, d))
        assert check_dense(q, kc, kc, lens) == (2, H, K, d, 16)
    q, kp, vp, table, lens = map(torch.from_numpy,
                                 _case(2, 48, 1, 512, (1, 9)))
    with pytest.raises(ValueError, match="head_dim 512"):
        check_paged("paged_gqa_decode", q, kp, vp, table, lens)
    with pytest.raises(ValueError, match="head_dim 512"):
        check_verify(q[:, None], kp, vp, table, lens)
    with pytest.raises(ValueError, match="head_dim 512"):
        kc = torch.zeros((2, 1, 16, 512))
        check_dense(q, kc, kc, lens)


@pytest.mark.gpu
def test_kernels_match_split_mirrors_on_card_at_granite():
    """Kernels 1 (bf16 and fp8 pools), 5, 6 (V 4, 192 rows) and 7 at
    granite's H48 K1 d128 on the card against their split mirrors (a bf16
    query within one bf16 step plus MIRROR_ATOL, float32 within 2e-5),
    batch-1 rows equal to the batch's, verify rows equal to decode rows and
    two calls equal, all bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, K, d = GRANITE

    def close(out, mirror):
        if out.dtype == torch.bfloat16:
            assert bf16_excess(out, mirror) <= MIRROR_ATOL
        else:
            assert (out - mirror).abs().max().item() <= ATOL

    def batch_one(fn, args, per_slot):
        out = fn(*args)
        assert torch.equal(out, fn(*args))
        for b in range(args[0].shape[0]):
            one = fn(*[x[b:b + 1] if i in per_slot else x
                       for i, x in enumerate(args)])
            assert torch.equal(one, out[b:b + 1]), b
        return out

    for qd in (torch.float32, torch.bfloat16):
        for pools in ("bf16", "fp8"):
            args = [x.cuda() for x in _args(_case(
                11, H, K, d, LENGTHS), pools)[1]]
            args[0] = args[0].to(qd)
            out = batch_one(paged_gqa_decode, args, (0, 3, 4))
            close(out, paged_gqa_decode_split_ref(*args))
            vargs = [x.cuda() for x in _args(_case(
                12, H, K, d, BASES, V), pools)[1]]
            vargs[0] = vargs[0].to(qd)
            out = batch_one(paged_gqa_verify, vargs, (0, 3, 4))
            close(out, paged_gqa_verify_split_ref(*vargs))
            q, kp, vp, table, base = vargs
            for v in range(V):
                assert torch.equal(out[:, v], paged_gqa_decode(
                    q[:, v].contiguous(), kp, vp, table, base + v + 1)), v
        qargs = [torch.from_numpy(x).cuda() for x in _quant_case(13, H, K, d)]
        qargs[0] = qargs[0].to(qd)
        out = batch_one(paged_gqa_decode_quant, qargs, (0, 5, 6))
        close(out, paged_gqa_decode_quant_split_ref(*qargs))
        q, k, v, lens = (torch.from_numpy(x).cuda()
                         for x in _dense_case(14, H, K, d))
        dargs = [q.to(qd), k.to(qd), v.to(qd), lens]
        out = batch_one(gqa_decode, dargs, (0, 1, 2, 3))
        close(out, gqa_decode_split_ref(*dargs, SPLIT_ROWS))
