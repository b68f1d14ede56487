"""Parity of the port's kernel modules (`repro_torch.kernels`) with the JAX
reference, on the CPU, where each wrapper runs its plain PyTorch version.

Inputs are drawn with numpy from fixed seeds and handed to both packages.
Tolerances: attention 2e-5 absolute in float32 (two float32 softmax orders);
bank statistics are float64, so counts must be equal and seconds agree to
rel 1e-12. The CUDA kernels themselves run only on the card: see
`test_kernels_match_plain_versions_on_card` and `chip_smoke.py`.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bank_energy.ref import bank_energy_np, exact_bank_stats_np
from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref
from repro.kernels.paged_gqa_decode import paged_gqa_decode as jax_paged
from repro.models.attention import blocked_attention
from repro_torch.kernels.bank_energy import (bank_activity_stats,
                                             bank_energy_ref,
                                             exact_bank_stats,
                                             exact_bank_stats_ref)
from repro_torch.kernels.bank_energy import running_time as scan
from repro_torch.kernels.bank_energy.ref import running_time
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.paged_gqa_decode import (paged_gqa_decode,
                                                  paged_gqa_decode_ref)

ATOL = 2e-5


def _paged_case(seed, H, K, d=16, ps=8, N=24, P=6,
                lengths=(1, 13, 48, 22)):
    """Ragged lengths (13 and 22 end on a partial page); slot 0 is inactive
    and points its whole table at the null page 0."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kp = rng.standard_normal((N, K, ps, d)).astype(np.float32)
    vp = rng.standard_normal((N, K, ps, d)).astype(np.float32)
    table = np.zeros((B, P), np.int32)
    perm = rng.permutation(np.arange(1, N))
    used = 0
    for b, n in enumerate(lengths):
        if b == 0:
            continue
        npg = -(-n // ps)
        table[b, :npg] = perm[used:used + npg]
        used += npg
    return q, kp, vp, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("backend", ["interpret", "ref"])
@pytest.mark.parametrize("H,K", [(4, 2), (4, 4), (6, 1)])
def test_paged_decode_matches_jax(backend, H, K):
    case = _paged_case(H * 10 + K, H, K)
    want = np.asarray(jax_paged(*map(jnp.asarray, case), backend=backend))
    got = paged_gqa_decode(*map(torch.from_numpy, case)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    plain = paged_gqa_decode_ref(*map(torch.from_numpy, case)).numpy()
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("S", [17, 33, 40])
@pytest.mark.parametrize("H,K", [(4, 2), (4, 4)])
def test_flash_attention_matches_jax(S, H, K):
    rng = np.random.default_rng(S)
    d = 16
    q = rng.standard_normal((2, S, H, d)).astype(np.float32)
    k = rng.standard_normal((2, S, K, d)).astype(np.float32)
    v = rng.standard_normal((2, S, K, d)).astype(np.float32)
    got = flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    blocked = np.asarray(blocked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    np.testing.assert_allclose(got, blocked, atol=ATOL, rtol=0)
    # the Pallas kernel's oracle takes the heads-major layout (B, H, S, d)
    ref = np.asarray(jax_flash_ref(*(jnp.asarray(x.transpose(0, 2, 1, 3))
                                     for x in (q, k, v))))
    np.testing.assert_allclose(got, ref.transpose(0, 2, 1, 3), atol=ATOL,
                               rtol=0)


def _bank_case(seed, S, C):
    """A trace mixing microsecond and sub-second segments (the reference's
    float32 path drifts on these) with zero-occupancy stretches, and a
    candidate grid with thresholds around the run lengths."""
    rng = np.random.default_rng(seed)
    d = np.where(rng.random(S) < 0.5, 1e-6, rng.random(S))
    o = rng.integers(0, 2**27, S).astype(np.float64)
    o[rng.random(S) < 0.3] = 0.0
    u = rng.uniform(2**20, 2**25, C)
    nb = rng.integers(1, 33, C).astype(np.float64)
    th = rng.uniform(0, 1e-3, C) * rng.integers(0, 3, C)
    return d, o, u, nb, th


def _rel(a, b):
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))


@pytest.mark.parametrize("seed,S,C", [(0, 1, 3), (1, 9, 17), (2, 300, 40),
                                      (3, 4000, 25)])
def test_exact_bank_stats_match_numpy(seed, S, C):
    d, o, u, nb, th = _bank_case(seed, S, C)
    want = exact_bank_stats_np(d, o, u, nb, th)
    got = exact_bank_stats(*map(torch.from_numpy, (d, o, u, nb, th)))
    got = got.numpy()
    np.testing.assert_array_equal(got[:, [1, 3]], want[:, [1, 3]])
    assert _rel(got[:, [0, 2, 4]], want[:, [0, 2, 4]]) <= 1e-12


@pytest.mark.parametrize("seed,S,C", [(4, 1, 2), (5, 50, 11), (6, 3000, 30)])
def test_bank_energy_lower_bound_matches_numpy(seed, S, C):
    d, o, u, nb, _ = _bank_case(seed, S, C)
    want = bank_energy_np(d, o, u, nb)
    got = bank_activity_stats(*map(torch.from_numpy, (d, o, u, nb))).numpy()
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    assert _rel(got[:, 0], want[:, 0]) <= 1e-12


def test_running_time_is_sequential_like_np_cumsum():
    d = np.random.default_rng(7).random(10_000) * 1e-3
    np.testing.assert_array_equal(running_time(torch.from_numpy(d)).numpy(),
                                  np.r_[0.0, np.cumsum(d)])


def test_empty_bank_inputs_give_zero_rows():
    e = torch.zeros(0, dtype=torch.float64)
    c = torch.ones(3, dtype=torch.float64)
    assert exact_bank_stats(e, e, c, c, c).shape == (3, 5)
    assert bank_activity_stats(e, e, c, c).abs().sum() == 0


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_card():
    """Each CUDA kernel against its plain version on the same inputs (run
    on a machine with a card: `python -m pytest -m gpu tests`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = "cuda"
    for H, K in [(12, 2), (4, 4)]:
        case = [torch.from_numpy(x).to(dev)
                for x in _paged_case(1, H, K, d=128, ps=16, N=40, P=5,
                                     lengths=(1, 65, 80, 17))]
        got = paged_gqa_decode(*case)
        want = paged_gqa_decode_ref(*case)
        assert (got - want).abs().max().item() <= ATOL
    rng = np.random.default_rng(0)
    for S in (17, 200):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (1, S, h, 64)).astype(np.float32)).to(dev) for h in (6, 2, 2))
        err = (flash_attention(q, k, v)
               - flash_attention_ref(q, k, v)).abs().max().item()
        assert err <= ATOL
    d, o, u, nb, th = (torch.from_numpy(x).to(dev)
                       for x in _bank_case(2, 3000, 40))
    got, want = exact_bank_stats(d, o, u, nb, th), exact_bank_stats_ref(
        d, o, u, nb, th)
    assert torch.equal(got[:, [1, 3]], want[:, [1, 3]])
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= 1e-12
    got, want = bank_activity_stats(d, o, u, nb), bank_energy_ref(d, o, u, nb)
    assert torch.equal(got[:, 1], want[:, 1])
    assert math.isclose(float((got - want).abs().max()), 0.0, abs_tol=1e-6)


@pytest.mark.gpu
def test_decode_kernel_on_fp8_and_mixed_pools_on_card():
    """Kernel 1 on the pools the quantized and mixed paths give it: fp8
    E4M3 codes, and float32 / float16 pools under a bfloat16 query."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.quant import to_fp8_codes
    q, kp, vp, table, lens = (torch.from_numpy(x).to("cuda") for x in
                              _paged_case(3, 12, 2, d=128, ps=16, N=40, P=5,
                                          lengths=(1, 65, 80, 17)))
    for qd, tol in ((torch.float32, ATOL), (torch.bfloat16, 1e-2)):
        for pools in ((to_fp8_codes(kp), to_fp8_codes(vp)),
                      (kp, vp), (kp.half(), vp.half())):
            got = paged_gqa_decode(q.to(qd), *pools, table, lens)
            want = paged_gqa_decode_ref(q, *pools, table, lens)
            assert got.dtype == qd
            assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.gpu
def test_quant_decode_kernel_matches_plain_versions_on_card():
    """Kernel 5 on int8 pools with per-row scales, against the page-by-page
    mirror and the vectorised plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.paged_gqa_decode import (
        paged_gqa_decode_quant, paged_gqa_decode_quant_mirror_ref,
        paged_gqa_decode_quant_ref)
    from repro_torch.kernels.quant import quantize_page_rows
    for H, K, d in [(12, 2, 128), (25, 25, 64), (4, 4, 16)]:
        q, kf, vf, table, lens = (torch.from_numpy(x).to("cuda") for x in
                                  _paged_case(H, H, K, d=d, ps=16, N=40, P=5,
                                              lengths=(1, 65, 80, 17)))
        (kp, ks), (vp, vs) = quantize_page_rows(kf), quantize_page_rows(vf)
        for qd, tol in ((torch.float32, ATOL), (torch.bfloat16, 1e-2)):
            args = (kp, vp, ks, vs, table, lens)
            got = paged_gqa_decode_quant(q.to(qd), *args).float()
            for ref in (paged_gqa_decode_quant_mirror_ref,
                        paged_gqa_decode_quant_ref):
                assert (got - ref(q, *args)).abs().max().item() <= tol


@pytest.mark.gpu
def test_int8_matmul_kernel_matches_plain_version_on_card():
    """Kernel 8: int32 accumulators exactly equal, the scaled output bit
    for bit, on ragged shapes (M, N, K not multiples of the tiles)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.int8_matmul import (int8_matmul,
                                                 int8_matmul_acc,
                                                 int8_matmul_acc_ref,
                                                 int8_matmul_ref)
    rng = np.random.default_rng(4)
    for M, K, N in [(499, 96, 200), (7, 41, 9), (128, 1536, 256),
                    (64, 8960, 64)]:
        x = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
        x[0], w[:, 0] = 127, -127
        sx = torch.from_numpy(rng.uniform(1e-4, 1, (M, 1)).astype(np.float32))
        sw = torch.from_numpy(rng.uniform(1e-4, 1, (1, N)).astype(np.float32))
        x, w, sx, sw = (t.to("cuda") for t in (x, w, sx, sw))
        assert torch.equal(int8_matmul_acc(x, w), int8_matmul_acc_ref(x, w))
        assert torch.equal(int8_matmul(x, w, sx, sw),
                           int8_matmul_ref(x, w, sx, sw))


def _verify_case_on_card(seed, B, H, K, d, ps, P, N, V):
    """Random pools and ragged base lengths for a V-row window; every
    slot's table covers base + V rows (slot 0's base is a page multiple)."""
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((N, K, ps, d)).astype(np.float32)
    vp = rng.standard_normal((N, K, ps, d)).astype(np.float32)
    q = rng.standard_normal((B, V, H, d)).astype(np.float32)
    base = rng.integers(1, P * ps - V + 1, B)
    base[0] = ps * max(1, int(base[0]) // ps)
    table = np.zeros((B, P), np.int32)
    ids = list(rng.permutation(np.arange(1, N)))
    for b in range(B):
        for j in range(-(-(int(base[b]) + V) // ps)):
            table[b, j] = ids.pop()
    return [torch.from_numpy(x).to("cuda")
            for x in (q, kp, vp, table, base.astype(np.int32))]


@pytest.mark.gpu
def test_verify_kernel_matches_plain_version_and_decode_on_card():
    """Kernel 6 against its plain version on float32, bfloat16 and fp8
    pools, and row v against kernel 1 at base + v + 1: the same
    operations, so bit for bit. V 6 at group 6 and d 128 (36 rows, 4,608
    query elements) runs in two row chunks; a head dim above 256 is
    refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.paged_gqa_verify import (paged_gqa_verify,
                                                      paged_gqa_verify_ref)
    from repro_torch.kernels.quant import to_fp8_codes
    for H, K, d, V in [(12, 2, 128, 4), (25, 25, 64, 3), (8, 2, 32, 2),
                       (12, 2, 128, 6)]:
        q, kp, vp, table, base = _verify_case_on_card(V + H, 3, H, K, d, 16,
                                                      6, 40, V)
        for pools, qd, tol in (((kp, vp), torch.float32, ATOL),
                               ((kp.bfloat16(), vp.bfloat16()),
                                torch.bfloat16, 1e-2),
                               ((to_fp8_codes(kp), to_fp8_codes(vp)),
                                torch.float32, ATOL)):
            got = paged_gqa_verify(q.to(qd), *pools, table, base)
            want = paged_gqa_verify_ref(q, *pools, table, base)
            assert got.dtype == qd and got.shape == q.shape
            assert (got.float() - want).abs().max().item() <= tol
            for v in range(V):
                row = paged_gqa_decode(q[:, v].to(qd), *pools, table,
                                       base + v + 1)
                assert torch.equal(got[:, v], row)
    q, kp, vp, table, base = _verify_case_on_card(0, 2, 12, 2, 512, 16, 6,
                                                  40, 2)
    with pytest.raises(ValueError, match="head_dim 512"):
        paged_gqa_verify(q, kp, vp, table, base)


@pytest.mark.gpu
def test_dense_decode_kernel_matches_plain_version_on_card():
    """Kernel 7 through the transposed (B, K, T, d) view of a (B, T, K, d)
    cache, on float32, bfloat16 and float16 caches, with ragged lengths and
    one past T."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.gqa_decode import gqa_decode, gqa_decode_ref
    rng = np.random.default_rng(5)
    for H, K, d, T in [(12, 2, 128, 640), (25, 25, 64, 100), (4, 4, 16, 33)]:
        q = torch.from_numpy(rng.standard_normal((4, H, d)).astype(
            np.float32)).cuda()
        k, v = (torch.from_numpy(rng.standard_normal((4, T, K, d)).astype(
            np.float32)).cuda() for _ in range(2))
        lens = torch.tensor([1, T // 3, T, T + 5], dtype=torch.int32).cuda()
        for cd, qd, tol in ((torch.float32, torch.float32, ATOL),
                            (torch.bfloat16, torch.bfloat16, 1e-2),
                            (torch.float16, torch.float32, ATOL)):
            kc, vc = k.to(cd).transpose(1, 2), v.to(cd).transpose(1, 2)
            got = gqa_decode(q.to(qd), kc, vc, lens)
            want = gqa_decode_ref(q, kc, vc, lens)
            assert got.dtype == qd
            assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("H,K,d", [(12, 2, 128), (25, 25, 64)])
def test_flash_tensor_core_kernel_on_card(H, K, d):
    """The bf16 tensor-core prefill kernel at ragged S against its mirror
    (within one bf16 step at the output's largest magnitude, and each
    element within one bf16 step of the mirror's plus MIRROR_ATOL)
    and the float32 plain version (the bf16 tolerance, 1e-2); row r of a
    prompt equals row r of a longer prompt with the same prefix, bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import (
        MIRROR_ATOL, bf16_excess, bf16_step, flash_attention_bf16_mirror_ref,
        variant)
    rng = np.random.default_rng(d)
    S2 = 333
    q, k, v = (torch.from_numpy(rng.standard_normal((2, S2, h, d)).astype(
        np.float32)).to("cuda", torch.bfloat16) for h in (H, K, K))
    assert variant(q) == "tensor-core"
    for S in (1, 17, 64, 100, S2):
        got = flash_attention(q[:, :S], k[:, :S], v[:, :S])
        mirror = flash_attention_bf16_mirror_ref(q[:, :S], k[:, :S],
                                                 v[:, :S])
        assert (got.float() - mirror.float()).abs().max().item() <= bf16_step(
            mirror).max().item()
        assert bf16_excess(got, mirror) <= MIRROR_ATOL
        ref = flash_attention_ref(q[:, :S].float(), k[:, :S].float(),
                                  v[:, :S].float())
        assert (got.float() - ref).abs().max().item() <= 1e-2
    long = flash_attention(q, k, v)
    for S1 in (17, 100, 200):
        short = flash_attention(q[:, :S1], k[:, :S1], v[:, :S1])
        assert torch.equal(long[:, :S1], short)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_kernels_with_query_offset_on_card(dtype):
    """Both prefill kernels with a query offset (the suffix rows of a
    shared or chunked prefill): at offsets 0, 16, 21 and 384 and suffixes
    of 1, 37 and 256 rows, within the kernel's tolerance of the float32
    plain version (bf16: 1e-2 and its mirror with the offset within one
    bf16 step plus MIRROR_ATOL; float32: 2e-5), and every row equal to
    row m + s of the offset-0 call over the same keys, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import (
        MIRROR_ATOL, bf16_excess, flash_attention_bf16_mirror_ref, variant)
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(21)
    H, K, d, T = 12, 2, 128, 384 + 256
    q_all, k, v = (torch.from_numpy(rng.standard_normal((1, T, h, d)).astype(
        np.float32)).to("cuda", dt) for h in (H, K, K))
    assert variant(q_all) == ("tensor-core" if dtype == "bfloat16"
                              else "cuda-core")
    for m in (0, 16, 21, 384):
        for S in (1, 37, 256):
            q, kk, vv = q_all[:, m:m + S], k[:, :m + S], v[:, :m + S]
            got = flash_attention(q, kk, vv, q_offset=m)
            whole = flash_attention(q_all[:, :m + S], kk, vv)
            assert torch.equal(got, whole[:, m:]), (m, S)
            ref = flash_attention_ref(q.float(), kk.float(), vv.float(), m)
            tol = 1e-2 if dtype == "bfloat16" else ATOL
            assert (got.float() - ref).abs().max().item() <= tol, (m, S)
            if dtype == "bfloat16":
                mirror = flash_attention_bf16_mirror_ref(q, kk, vv, m)
                assert bf16_excess(got, mirror) <= MIRROR_ATOL, (m, S)


@pytest.mark.gpu
def test_split_decode_kernel_on_card():
    """`gqa_decode`'s split path against the plain version and the split
    mirror at B 8 and B 1 (float32 2e-5, bf16 1e-2), through the (B, K, T,
    d) view of a (B, T, K, d) cache, at T 640 (10 splits) and T 1100 (18
    splits: the merge reads two chunks of 16), with lengths on both sides
    of split and chunk boundaries; each batch-1 call on one sequence gives
    that sequence's batch-8 row bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.gqa_decode import (SPLIT_ROWS, gqa_decode,
                                                gqa_decode_ref,
                                                gqa_decode_split_ref)
    rng = np.random.default_rng(9)
    for H, K, d, T, lengths in [
            (12, 2, 128, 640, [0, 1, 64, 65, 300, 639, 640, 647]),
            (25, 25, 64, 640, [0, 1, 64, 65, 300, 639, 640, 647]),
            (12, 2, 128, 1100, [0, 700, 1023, 1024, 1025, 1090, 1100, 1107])]:
        q = torch.from_numpy(rng.standard_normal((8, H, d)).astype(
            np.float32)).cuda()
        k, v = (torch.from_numpy(rng.standard_normal((8, T, K, d)).astype(
            np.float32)).cuda() for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32).cuda()
        for dt, tol in ((torch.float32, ATOL), (torch.bfloat16, 1e-2)):
            kc, vc = k.to(dt).transpose(1, 2), v.to(dt).transpose(1, 2)
            qd = q.to(dt)
            got = gqa_decode(qd, kc, vc, lens)
            for want in (gqa_decode_ref(q, kc, vc, lens),
                         gqa_decode_split_ref(q, kc, vc, lens, SPLIT_ROWS)):
                assert (got.float() - want.float()).abs().max().item() <= tol
            assert not got[0].any()
            for b in range(8):
                one = gqa_decode(qd[b:b + 1], kc[b:b + 1], vc[b:b + 1],
                                 lens[b:b + 1])
                assert torch.equal(one, got[b:b + 1]), b
    # a view whose rows are not 16-byte aligned is copied, not refused
    kc, vc = (torch.zeros(x.numel() + 1, device="cuda")[1:].view_as(x)
              .copy_(x).transpose(1, 2) for x in (k, v))
    assert kc.data_ptr() % 16
    assert torch.equal(gqa_decode(q, kc, vc, lens),
                       gqa_decode(q, k.transpose(1, 2), v.transpose(1, 2),
                                  lens))


@pytest.mark.parametrize("M,K,N,sms,want", [
    (499, 1536, 8960, 132, 1),     # 280 output tiles fill 132 SMs
    (499, 8960, 1536, 132, 5),     # 48 tiles: two rounds of 240 blocks
    (64, 8960, 64, 132, 70),       # one tile: a slice per k-tile
    (499, 8960, 1536, 48, 1)])     # as many tiles as SMs
def test_int8_matmul_split_k_count(M, K, N, sms, want):
    """The wrapper's split-K count (host arithmetic, no card): whole
    k-tiles per slice, never more slices than k-tiles."""
    from repro_torch.kernels.int8_matmul import split_k
    assert split_k(M, N, K, sms) == want
    assert 1 <= want <= -(-K // 128)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [
    (499, 1536, 8960), (499, 8960, 1536),    # the int8 SwiGLU's two shapes
    (1, 1536, 8960), (1, 8960, 1536),        # one token
    (499, 96, 200),                          # N not a multiple of 16 or 128
    (37, 100, 130),                          # K, N not multiples of 8 or 32
    (130, 8960, 72), (3, 8961, 24)])         # split K, ragged edges
def test_int8_matmul_tensor_core_kernel_on_card(M, K, N):
    """Kernel 8 on the tensor cores: int32 accumulators exactly equal to
    the plain version's and the scaled output bit for bit, at shapes that
    reach every edge of the tiling and both the split-K path (K 8960 on a
    short output) and the direct one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.int8_matmul import (int8_matmul,
                                                 int8_matmul_acc,
                                                 int8_matmul_acc_ref,
                                                 int8_matmul_ref, split_k)
    rng = np.random.default_rng(M + K + N)
    x = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    x[0], w[:, -1] = 127, -127
    sx = torch.from_numpy(rng.uniform(1e-4, 1, (M, 1)).astype(np.float32))
    sw = torch.from_numpy(rng.uniform(1e-4, 1, (1, N)).astype(np.float32))
    x, w, sx, sw = (t.to("cuda") for t in (x, w, sx, sw))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if K == 8960 and N == 1536 or (M, N) == (130, 72):
        assert split_k(M, N, K, sms) > 1
    assert torch.equal(int8_matmul_acc(x, w), int8_matmul_acc_ref(x, w))
    assert torch.equal(int8_matmul(x, w, sx, sw),
                       int8_matmul_ref(x, w, sx, sw))


@pytest.mark.gpu
@pytest.mark.parametrize("H,K,d", [(12, 2, 128), (25, 25, 64), (4, 4, 16)])
def test_quant_decode_split_kernel_on_card(H, K, d):
    """Kernel 5 on the split-context path, through a 1152-row table (18
    splits, so the merge reads two chunks of 16): against the split mirror
    element by element (float32 2e-5; bf16 within one bf16 step of the
    mirror plus MIRROR_ATOL), against the page mirror and the plain version
    on the same query (float32 2e-5; bf16 1e-2, or one bf16 step of the
    output where that is larger), with a null-page slot, a one-row slot and
    lengths on both sides of split edges; each slot's batch-1 call equals
    its row of the batch-8 call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import (MIRROR_ATOL,
                                                     bf16_excess, bf16_step)
    from repro_torch.kernels.paged_gqa_decode import (
        paged_gqa_decode_quant, paged_gqa_decode_quant_mirror_ref,
        paged_gqa_decode_quant_ref, paged_gqa_decode_quant_split_ref)
    from repro_torch.kernels.quant import quantize_page_rows
    lengths = (1, 1, 64, 65, 1023, 1024, 1025, 1152)
    q, kf, vf, table, lens = (torch.from_numpy(x).to("cuda") for x in
                              _paged_case(d, H, K, d=d, ps=16, N=300, P=72,
                                          lengths=lengths))
    (kp, ks), (vp, vs) = quantize_page_rows(kf), quantize_page_rows(vf)
    args = (kp, vp, ks, vs, table, lens)
    for qd, tol in ((torch.float32, ATOL), (torch.bfloat16, 1e-2)):
        got = paged_gqa_decode_quant(q.to(qd), *args)
        split = paged_gqa_decode_quant_split_ref(q.to(qd), *args)
        assert got.dtype == qd
        if qd == torch.float32:
            assert (got - split).abs().max().item() <= ATOL
        else:
            assert bf16_excess(got, split) <= MIRROR_ATOL
        # the plain versions on the query the kernel was given; a bf16
        # output past 4 rounds by up to half of its 2^-5 step, above 1e-2
        for ref in (paged_gqa_decode_quant_mirror_ref,
                    paged_gqa_decode_quant_ref):
            want = ref(q.to(qd).float(), *args)
            lim = tol if qd == torch.float32 else max(
                tol, bf16_step(want).max().item())
            assert (got.float() - want).abs().max().item() <= lim
        for b in range(len(lengths)):
            one = paged_gqa_decode_quant(q[b:b + 1].to(qd), kp, vp, ks, vs,
                                         table[b:b + 1], lens[b:b + 1])
            assert torch.equal(one, got[b:b + 1]), b


def _nan_past_lengths(pool, table, lengths, first):
    """fp8 codes of each non-null slot's pages at positions >= first[b] set
    to the NaN code 0x7F: rows the kernels must not read."""
    ps = pool.shape[2]
    pool = pool.clone()
    for b in range(1, table.shape[0]):
        for t in range(int(first[b]), -(-int(lengths[b]) // ps) * ps):
            pool[int(table[b, t // ps]), :, t % ps] = 0x7F
    return pool


@pytest.mark.gpu
@pytest.mark.parametrize("H,K,d", [(12, 2, 128), (25, 25, 64), (4, 4, 16)])
def test_paged_decode_and_verify_split_kernels_on_card(H, K, d):
    """Kernels 1 and 6 on the split-context path, through a 1152-row table
    (18 splits, so the merge reads two chunks of 16), on float32, bfloat16,
    float16 and fp8 pools under a float32 and a bfloat16 query: against
    their split mirrors element by element (float32 2e-5; bf16 within one
    bf16 step of the mirror plus MIRROR_ATOL), with a null-page slot, a
    one-row slot and lengths on both sides of split edges; each slot's
    batch-1 call equals its row of the batch-8 call; verify row v equals
    kernel 1 at base + v + 1. fp8 pages hold the NaN code past what any
    window row reads, which the kernels must leave unread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import MIRROR_ATOL, bf16_excess
    from repro_torch.kernels.paged_gqa_decode import (
        paged_gqa_decode_split_ref)
    from repro_torch.kernels.paged_gqa_verify import (
        paged_gqa_verify, paged_gqa_verify_split_ref)
    from repro_torch.kernels.quant import to_fp8_codes
    V = 4
    lengths = (1, 1, 64, 65, 1023, 1024, 1025, 1152)
    q, kf, vf, table, lens = (torch.from_numpy(x).to("cuda") for x in
                              _paged_case(d + H, H, K, d=d, ps=16, N=300,
                                          P=72, lengths=lengths))
    qv = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (len(lengths), V, H, d)).astype(np.float32)).cuda()
    base = (lens - V).clamp(min=0)
    fp8 = [_nan_past_lengths(to_fp8_codes(x), table, lens,
                             torch.maximum(lens, base + V)) for x in (kf, vf)]
    for pools in ((kf, vf), (kf.bfloat16(), vf.bfloat16()),
                  (kf.half(), vf.half()), fp8):
        for qd in (torch.float32, torch.bfloat16):
            for fn, mirror, x, n in (
                    (paged_gqa_decode, paged_gqa_decode_split_ref, q, lens),
                    (paged_gqa_verify, paged_gqa_verify_split_ref, qv,
                     base)):
                got = fn(x.to(qd), *pools, table, n)
                want = mirror(x.to(qd), *pools, table, n)
                assert got.dtype == qd and got.shape == x.shape
                assert bool(torch.isfinite(got.float()).all())
                if qd == torch.float32:
                    assert (got - want).abs().max().item() <= ATOL
                else:
                    assert bf16_excess(got, want) <= MIRROR_ATOL
                for b in range(len(lengths)):
                    one = fn(x[b:b + 1].to(qd), *pools, table[b:b + 1],
                             n[b:b + 1])
                    assert torch.equal(one, got[b:b + 1]), b
                if fn is paged_gqa_verify:
                    for v in range(V):
                        assert torch.equal(got[:, v], paged_gqa_decode(
                            qv[:, v].to(qd), *pools, table, base + v + 1))


@pytest.mark.gpu
def test_fp8_decode_of_every_code_on_card():
    """The kernels' E4M3 decode gives each of the 256 codes exactly as the
    plain version's table (NaN for 0x7F / 0xFF): one slot of length 1
    whose V row holds every code comes out as that row, since p = 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.quant import fp8_table
    kp = torch.zeros((2, 1, 16, 256), dtype=torch.uint8, device="cuda")
    vp = kp.clone()
    vp[1, 0, 0] = torch.arange(256, dtype=torch.uint8)
    q = torch.zeros((1, 1, 256), device="cuda")
    table = torch.ones((1, 1), dtype=torch.int32, device="cuda")
    got = paged_gqa_decode(q, kp, vp, table,
                           torch.ones(1, dtype=torch.int32, device="cuda"))
    want = fp8_table().cuda()
    assert torch.equal(got[0, 0].isnan(), want.isnan())
    assert torch.equal(got[0, 0].nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("S,C,bmax,sms", [
    (1 << 20, 360, 32, 132),    # chip_smoke.py's synthetic sweep
    (1 << 20, 1, 32, 132),      # the pruned sweep's incumbent call
    (1 << 20, 360, 256, 132),   # summaries capped
    (24, 15, 16, 132),          # the serve trace's sweep
    (3000, 40, 256, 132), (513, 3, 8, 132), (1, 1, 1, 132)])
def test_walk_plan_covers_the_trace(S, C, bmax, sms):
    """The exact kernel's plan (host arithmetic, no card): a block's 8
    warps are G candidates x W chunks, chunks are whole staged pieces, Q
    of them cover the trace exactly once, and the summaries stay within
    their cap."""
    from repro_torch.kernels.bank_energy.ops import (WALK_STAGE,
                                                     WALK_SUMMARY_MAX,
                                                     walk_plan)
    G, W, chunk, Q = walk_plan(S, C, bmax, sms)
    assert G * W == 8 and G & (G - 1) == 0 and G <= C
    assert chunk % (WALK_STAGE // W) == 0
    assert (Q - 1) * chunk < S <= Q * chunk
    assert Q == 1 or C * bmax * Q <= WALK_SUMMARY_MAX


@pytest.mark.parametrize("S,C,sms", [(1 << 20, 360, 132), (1 << 20, 1, 132),
                                     (24, 15, 132), (3000, 300, 132)])
def test_energy_plan_covers_the_grid(S, C, sms):
    from repro_torch.kernels.bank_energy.ops import (ENERGY_GROUP_MAX,
                                                     energy_plan)
    tile, group = energy_plan(S, C, sms)
    assert tile % 256 == 0 and 256 <= tile <= 2048
    assert group <= ENERGY_GROUP_MAX and -(-C // group) * group >= C


def test_exact_bank_stats_takes_the_running_time():
    d, o, u, nb, th = map(torch.from_numpy, _bank_case(8, 200, 6))
    with_cum = exact_bank_stats(d, o, u, nb, th, cum=scan(d))
    assert torch.equal(with_cum, exact_bank_stats(d, o, u, nb, th))
    with pytest.raises(ValueError):
        exact_bank_stats(d, o, u, nb, th, cum=scan(d)[:-1])


def _wide_bank_case(seed, S, C, wide):
    """`_bank_case` with some candidates at 1 bank and, when `wide`, some
    at 256 banks whose usable size spreads the activity over all 256."""
    rng = np.random.default_rng(seed + 100)
    d, o, u, nb, th = _bank_case(seed, S, C)
    nb[::5] = 1
    if wide:
        nb[1::3] = 256
        u[1::3] = rng.uniform(2**27 / 300, 2**27 / 200, len(u[1::3]))
    return d, o, u, nb, th


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 40, 360])
@pytest.mark.parametrize("S", [1, 511, 512, 513, 3000, 1 << 20])
def test_bank_kernels_at_chunk_edges_on_card(S, C):
    """Kernels 3 and 4 against their plain versions across the walk's
    chunk edges (chunks are at least 512 segments: S 511-513 give one or
    two) and at a million segments, on a trace whose activity changes at
    almost every segment, with bank counts from 1 to 256 (up to 32 at a
    million segments, where the plain version's (C, B, S) temporaries
    would be too slow): counts equal, seconds within rel 1e-12 (float64
    sums in another order), two calls equal bit for bit, and a call that
    runs its own scan equal to one given the running time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d, o, u, nb, th = (torch.from_numpy(x).cuda() for x in _wide_bank_case(
        S % 97, S, C, wide=S <= 3000))
    for fn, ref, args, counts in (
            (exact_bank_stats, exact_bank_stats_ref, (d, o, u, nb, th),
             [1, 3]),
            (bank_activity_stats, bank_energy_ref, (d, o, u, nb), [1])):
        got, want = fn(*args), ref(*args)
        assert torch.equal(got, fn(*args))
        assert torch.equal(got[:, counts], want[:, counts])
        assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= 1e-12
    assert torch.equal(exact_bank_stats(d, o, u, nb, th, cum=scan(d)),
                       exact_bank_stats(d, o, u, nb, th))


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 2, 511, 512, 513, 1024, 1 << 20,
                               (1 << 20) + 3])
def test_running_time_kernel_is_np_cumsum_on_card(S):
    """The scan kernel gives np.r_[0, np.cumsum(d)] bit for bit (a first
    duration of -0.0 included), from an aligned tensor and from a view 8
    bytes off alignment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(S)
    d = (np.where(rng.random(S) < 0.5, 1e-6, rng.random(S))
         * rng.choice([1.0, 1e-3, 1e3], S))
    d[rng.random(S) < 0.1] = 0.0
    d[0] = -0.0
    want = np.r_[0.0, np.cumsum(d)].view(np.int64)
    for t in (torch.from_numpy(d).cuda(),
              torch.from_numpy(np.r_[0.0, d]).cuda()[1:]):
        got = scan(t).cpu().numpy()
        np.testing.assert_array_equal(got.view(np.int64), want)


@pytest.mark.gpu
def test_bank_kernels_at_bank_edges_on_card():
    """The kernels' division keeps a zero occupancy off CUDA's slow path by
    taking +0 / u or -0 / u, divided once per candidate: activities at
    occupancies of +-0, at exact multiples of the usable size and at their
    nextafter neighbours equal the plain version's (counts equal, seconds
    within rel 1e-12)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    u = np.array([0.9 * 2**27 / 5, 1000.0, 3.0, 2.0**-20, np.inf])
    nb = np.array([5.0, 256.0, 7.0, 3.0, 2.0])
    mult = np.concatenate([k * u[:3] for k in range(0, 8)])
    occ = np.concatenate([[0.0, -0.0], mult, np.nextafter(mult, np.inf),
                          np.nextafter(mult, 0.0), [2**27, 1.0]])
    occ = np.repeat(occ, 3)
    occ[::7] = -0.0
    d = np.random.default_rng(3).random(len(occ)) * 1e-3
    th = np.array([1e-3, 0.0, 5e-3, 1e-4, 2e-3])
    d, o, u, nb, th = (torch.from_numpy(x).cuda() for x in (d, occ, u, nb,
                                                            th))
    for fn, ref, args, counts in (
            (exact_bank_stats, exact_bank_stats_ref, (d, o, u, nb, th),
             [1, 3]),
            (bank_activity_stats, bank_energy_ref, (d, o, u, nb), [1])):
        got, want = fn(*args), ref(*args)
        assert torch.equal(got[:, counts], want[:, counts])
        assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 40])
def test_bank_kernels_on_empty_stretches_on_card(C):
    """On a trace of stretches of zero occupancy and busy stretches, 1 to
    5000 segments each (so whole walk pieces and lower-bound tiles are
    empty, and some runs span many of them), both kernels equal their
    plain versions (counts equal, seconds within rel 1e-12) and give the
    same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(C)
    lens = rng.integers(1, 5001, 40)
    busy = np.arange(len(lens)) % 2 == 1
    o = np.concatenate([rng.integers(1, 2**27, n).astype(np.float64) if b
                        else np.zeros(n) for n, b in zip(lens, busy)])
    S = len(o)
    d = np.where(rng.random(S) < 0.5, 1e-6, rng.random(S))
    _, _, u, nb, th = _wide_bank_case(5, 10, C, wide=True)
    d, o, u, nb, th = (torch.from_numpy(x).cuda() for x in (d, o, u, nb,
                                                            th))
    for fn, ref, args, counts in (
            (exact_bank_stats, exact_bank_stats_ref, (d, o, u, nb, th),
             [1, 3]),
            (bank_activity_stats, bank_energy_ref, (d, o, u, nb), [1])):
        got, want = fn(*args), ref(*args)
        assert torch.equal(got, fn(*args))
        assert torch.equal(got[:, counts], want[:, counts])
        assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [0.0, 257.0, 2.5, float("nan")])
def test_bank_kernels_refuse_bad_bank_counts_on_card(bad):
    """Both wrappers raise when a bank count is not an integer in
    [1, 256], also where the kernel was queued before the counts were read
    back, and the stream stays usable after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d, o, u, nb, th = (torch.from_numpy(x).cuda() for x in _bank_case(
        4, 3000, 6))
    nb[2] = bad
    with pytest.raises(ValueError, match="bank counts"):
        bank_activity_stats(d, o, u, nb)
    with pytest.raises(ValueError, match="bank counts"):
        exact_bank_stats(d, o, u, nb, th)
    nb[2] = 4.0
    assert torch.equal(exact_bank_stats(d, o, u, nb, th)[:, [1, 3]],
                       exact_bank_stats_ref(d, o, u, nb, th)[:, [1, 3]])
