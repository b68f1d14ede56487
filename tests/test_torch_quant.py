"""Parity of the port's quantization helpers (`repro_torch.kernels.quant`),
its quantized paged-decode plain versions and its int8 matmul with the JAX
reference, on the CPU, on numpy inputs drawn from fixed seeds.

Tolerances: quantization codes, scales, fp8 codes and the int8 matmul are
bit-exact (the same float32 arithmetic in the same order); the page-by-page
quantized decode mirror agrees within 1e-6 and the vectorised version
within 1e-5 (float32 sums in another order); decode on fp8 and mixed
float pools 1e-6 in float32 (the same gather and softmax as the reference's
plain version) and 1e-2 where the output is bfloat16, the bound slice 1's
chip checks use.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.kernels import quant as jq
from repro.kernels.int8_matmul import int8_matmul_ref as jax_int8_ref
from repro.kernels.paged_gqa_decode import paged_gqa_decode as jax_paged
from repro.kernels.paged_gqa_decode import \
    paged_gqa_decode_quant as jax_paged_quant
from repro.kernels.paged_gqa_decode.ref import \
    paged_gqa_decode_quant_mirror_ref as jax_mirror
from repro.serve.paged import page_bytes as jax_page_bytes
import repro_torch.configs as tconfigs
from repro_torch.kernels import quant as tq
from repro_torch.kernels.int8_matmul import (int8_matmul, int8_matmul_acc,
                                             int8_matmul_ref,
                                             quantized_linear)
from repro_torch.kernels.paged_gqa_decode import (
    paged_gqa_decode, paged_gqa_decode_quant,
    paged_gqa_decode_quant_mirror_ref, paged_gqa_decode_quant_ref,
    paged_gqa_decode_ref)
from repro_torch.serve import page_bytes

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16)}
KV_NAMES = ["native", "fp32", "bf16", "fp16", "int8", "fp8"]
# bytes per page at page_size 16 (bf16, int8 with scales, fp8)
PAGE_BYTES = {"dsr1d-qwen-1.5b": (458_752, 236_544, 229_376),
              "gpt2-xl": (4_915_200, 2_611_200, 2_457_600)}


def _quant_inputs(seed):
    """Rows of mixed magnitude, an all-zero row (the eps floor) and a row of
    exact .5 ties: amax 254 gives s = 2, so x / s = k / 2 for integer k."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((48, 80)) * rng.uniform(1e-3, 1e3, (48, 1))
    x[3] = 0.0
    x[7] = np.arange(80) - 40.0
    x[7, 0] = 254.0
    return x.astype(np.float32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fn", ["quantize_rows", "quantize_cols",
                                "quantize_page_rows"])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_matches_jax_bit_for_bit(fn, dtype, seed):
    x = _quant_inputs(seed)
    _, jdt, tdt = DTYPES[dtype]
    qj, sj = getattr(jq, fn)(jnp.asarray(x).astype(jdt))
    qt, st = getattr(tq, fn)(torch.from_numpy(x).to(tdt))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))
    if fn == "quantize_page_rows":
        np.testing.assert_array_equal(
            tq.dequantize_page_rows(qt, st).numpy(),
            np.asarray(jq.dequantize_page_rows(qj, sj)))


def test_every_fp8_code_decodes_as_the_reference():
    codes = np.arange(256, dtype=np.uint8)
    want = np.asarray(jq.from_fp8(jnp.asarray(codes)))
    got = tq.from_fp8(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got, want)       # NaNs at 0x7F and 0xFF
    assert np.isnan(got[[0x7F, 0xFF]]).all()
    native = codes.view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    np.testing.assert_array_equal(got, native)
    np.testing.assert_array_equal(
        tq.from_fp8(torch.from_numpy(codes).view(torch.float8_e4m3fn)).numpy(),
        got)


def test_fp8_codes_saturate_and_match_the_reference():
    x = (np.random.default_rng(2).standard_normal(4096) * 300).astype(
        np.float32)
    x[:4] = [1e4, -1e4, 448.0, -449.0]
    got = tq.to_fp8_codes(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jq.to_fp8_codes(jnp.asarray(x))))
    assert tq.from_fp8(got[:4]).tolist() == [448.0, -448.0, 448.0, -448.0]
    assert tq.is_fp8_pool(torch.uint8) and tq.is_fp8_pool(torch.float8_e4m3fn)
    assert not tq.is_fp8_pool(torch.int8)


@pytest.mark.parametrize("native", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", KV_NAMES)
def test_kv_dtype_spec_matches_jax(name, native):
    _, jdt, tdt = DTYPES[native]
    js = jq.kv_dtype_spec(name, native=jdt)
    ts = tq.kv_dtype_spec(name, native=tdt)
    assert (ts.name, ts.itemsize, ts.scale_bytes_per_row, ts.quantized,
            ts.has_scales) == (js.name, js.itemsize, js.scale_bytes_per_row,
                               js.quantized, js.has_scales)
    assert str(ts.pool_dtype).removeprefix("torch.") == js.pool_dtype.name
    assert tq.kv_dtype_bytes(name, tdt) == jq.kv_dtype_bytes(name, jdt)


def test_unknown_kv_dtype_raises():
    with pytest.raises(ValueError):
        tq.kv_dtype_spec("int4")
    with pytest.raises(ValueError):
        tq.kv_dtype_spec("native")


@pytest.mark.parametrize("arch", list(PAGE_BYTES))
def test_page_bytes_match_jax_and_the_quoted_figures(arch):
    cfg, tcfg = get_arch(arch), tconfigs.get_arch(arch)
    for name in KV_NAMES:
        ts = tq.kv_dtype_spec(name, native=torch.bfloat16)
        js = jq.kv_dtype_spec(name, native=jnp.bfloat16)
        got = page_bytes(tcfg, 16, ts.itemsize, ts.scale_bytes_per_row)
        assert got == jax_page_bytes(cfg, 16, js.itemsize,
                                     js.scale_bytes_per_row)
    specs = [tq.kv_dtype_spec(n) for n in ("bf16", "int8", "fp8")]
    assert tuple(page_bytes(tcfg, 16, s.itemsize, s.scale_bytes_per_row)
                 for s in specs) == PAGE_BYTES[arch]


def _paged_case(seed, H, K, d=16, ps=8, N=24, P=6, lengths=(1, 13, 48, 22)):
    """Ragged lengths (13 and 22 end on a partial page); slot 0 is inactive
    and points its whole table at the null page 0."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kv = rng.standard_normal((2, N, K, ps, d)).astype(np.float32)
    table = np.zeros((B, P), np.int32)
    perm = rng.permutation(np.arange(1, N))
    used = 0
    for b, n in enumerate(lengths[1:], start=1):
        npg = -(-n // ps)
        table[b, :npg] = perm[used:used + npg]
        used += npg
    return q, kv[0], kv[1], table, np.asarray(lengths, np.int32)


def _int8_case(seed, H, K):
    q, kf, vf, table, lens = _paged_case(seed, H, K)
    kp, ks = jq.quantize_page_rows(jnp.asarray(kf))
    vp, vs = jq.quantize_page_rows(jnp.asarray(vf))
    return [np.array(a) for a in (q, kp, vp, ks, vs, table, lens)]


@pytest.mark.parametrize("H,K", [(4, 2), (4, 4), (6, 1)])
def test_quant_decode_refs_match_jax(H, K):
    case = _int8_case(H * 10 + K, H, K)
    jcase = list(map(jnp.asarray, case))
    tcase = list(map(torch.from_numpy, case))
    want = np.asarray(jax_mirror(*jcase))
    np.testing.assert_allclose(
        paged_gqa_decode_quant_mirror_ref(*tcase).numpy(), want, atol=1e-6,
        rtol=0)
    np.testing.assert_allclose(paged_gqa_decode_quant_ref(*tcase).numpy(),
                               want, atol=1e-5, rtol=0)
    ref_backend = np.asarray(jax_paged_quant(*jcase, backend="ref"))
    got = paged_gqa_decode_quant(*tcase).numpy()         # CPU: plain path
    np.testing.assert_allclose(got, ref_backend, atol=1e-6, rtol=0)


@pytest.mark.parametrize("pool", ["fp8", "float32", "bfloat16", "float16"])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_decode_ref_on_fp8_and_mixed_pools_matches_jax(pool, qdtype):
    """Pools whose dtype differs from q's: fp8 codes (uint8) or float
    pools under a float32 or bfloat16 query, read as float32 by both."""
    q, kf, vf, table, lens = _paged_case(7, 4, 2)
    if pool == "fp8":
        kp = np.array(jq.to_fp8_codes(jnp.asarray(kf)))
        vp = np.array(jq.to_fp8_codes(jnp.asarray(vf)))
        jk, jv, tk, tv = (jnp.asarray(kp), jnp.asarray(vp),
                          torch.from_numpy(kp), torch.from_numpy(vp))
    else:
        npd, jdt, tdt = {"float16": (np.float16, jnp.float16, torch.float16),
                         **DTYPES}[pool]
        jk, jv = (jnp.asarray(x).astype(jdt) for x in (kf, vf))
        tk, tv = (torch.from_numpy(x).to(tdt) for x in (kf, vf))
    _, jqd, tqd = DTYPES[qdtype]
    want = jax_paged(jnp.asarray(q).astype(jqd), jk, jv, jnp.asarray(table),
                     jnp.asarray(lens), backend="ref")
    want = np.asarray(want.astype(jnp.float32))
    got = paged_gqa_decode(torch.from_numpy(q).to(tqd), tk, tv,
                           torch.from_numpy(table), torch.from_numpy(lens))
    assert got.dtype == tqd
    tol = 1e-6 if qdtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    plain = paged_gqa_decode_ref(torch.from_numpy(q).to(tqd), tk, tv,
                                 torch.from_numpy(table),
                                 torch.from_numpy(lens))
    assert torch.equal(got, plain)


@pytest.mark.parametrize("M,K,N", [(7, 40, 9), (33, 128, 64), (499, 96, 200)])
def test_int8_matmul_plain_matches_jax_bit_for_bit(M, K, N):
    rng = np.random.default_rng(M)
    x = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    x[0] = 127
    w[:, 0] = -127                        # extreme products
    sx = rng.uniform(1e-4, 1.0, (M, 1)).astype(np.float32)
    sw = rng.uniform(1e-4, 1.0, (1, N)).astype(np.float32)
    want = np.asarray(jax_int8_ref(*map(jnp.asarray, (x, w, sx, sw))))
    t = list(map(torch.from_numpy, (x, w, sx, sw)))
    got = int8_matmul(*t).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(int8_matmul_ref(*t).numpy()),
                                  _bits(want))
    acc = int8_matmul_acc(t[0], t[1])
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(),
                                  x.astype(np.int64) @ w.astype(np.int64))


def test_quantized_linear_matches_jax():
    from repro.kernels.int8_matmul import quantized_linear as jax_qlinear
    rng = np.random.default_rng(11)
    x = rng.standard_normal((21, 48)).astype(np.float32)
    w = rng.standard_normal((48, 30)).astype(np.float32)
    want = np.asarray(jax_qlinear(jnp.asarray(x), jnp.asarray(w),
                                  backend="ref"))
    got = quantized_linear(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_int8_swiglu_matches_the_reference_composition():
    """The walkthrough's int8 SwiGLU (`repro_torch.examples.int8_serving`)
    against the same composition of the reference's functions."""
    import jax
    from repro.kernels.int8_matmul import int8_matmul as jax_int8
    from repro_torch.examples.int8_serving import quantized_ffn
    rng = np.random.default_rng(12)
    D, F = 32, 72
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("w_gate", (D, F)), ("w_up", (D, F)),
                      ("w_down", (F, D)))}
    x = rng.standard_normal((2, 9, D)).astype(np.float32)

    def qmm(x2, w):
        xq, sx = jq.quantize_rows(x2)
        wq, sw = jq.quantize_cols(w)
        return jax_int8(xq, wq, sx, sw, backend="ref")

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    x2 = jnp.asarray(x).reshape(18, D)
    g = jax.nn.silu(qmm(x2, jp["w_gate"]))
    want = np.asarray(qmm(g * qmm(x2, jp["w_up"]), jp["w_down"]))
    got = quantized_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x)).reshape(18, D).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
