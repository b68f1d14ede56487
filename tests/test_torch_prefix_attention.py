"""The prefill kernel's plain versions with a query offset, against JAX
`blocked_attention(..., q_offset=m)` on the CPU (the kernel itself runs
only on the card: `tests/test_torch_kernels.py` and `chip_smoke.py`).

Query row s sits at position m + s and attends keys t <= m + s, the suffix
rows of a shared or chunked prefill. The reference pads the keys to a fixed
width (`pad_to`) and contracts them as one block; the port passes the m + S
keys unpadded. So each case is held both ways:

* `flash_attention_ref` (float32) within 2e-5 of JAX's padded one-block
  attention, with and without the padding on the port's side;
* `flash_attention_bf16_mirror_ref` (the tensor-core kernel's arithmetic)
  against JAX in bf16 with 64-key blocks, as `test_torch_fast_attention.py`
  holds it without an offset (within one bf16 step plus MIRROR_ATOL at head
  dim 64, one step at the output's largest magnitude at 128); its rows at
  offset m equal rows m.. of the offset-0 call bit for bit, and padding the
  keys changes no bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models.attention import blocked_attention
from repro_torch.kernels.flash_attention import (
    MIRROR_ATOL, bf16_excess, bf16_step, flash_attention,
    flash_attention_bf16_mirror_ref, flash_attention_ref)

ATOL = 2e-5
# (q_offset m, suffix rows S): a plain prefill, page-aligned and mid-page
# boundaries (page_size 16), one decode-like row, and a long prefix
CASES = [(0, 37), (16, 37), (21, 1), (21, 64), (100, 5)]
HEADS = {"dsr1d": (6, 1, 128), "dsr1d-d64": (6, 1, 64), "gpt2": (3, 3, 64)}


def _case(seed, m, S, H, K, d, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, S, H, d)).astype(np.float32)
    k = rng.standard_normal((1, m + S, K, d)).astype(np.float32)
    v = rng.standard_normal((1, m + S, K, d)).astype(np.float32)
    return [torch.from_numpy(x).to(dtype) for x in (q, k, v)]


def _pad(x, T):
    return F.pad(x, (0, 0, 0, 0, 0, T - x.shape[1]))


def _jax(q, k, v, m, kv_block, dtype):
    to = [jnp.asarray(x.float().numpy(), dtype) for x in (q, k, v)]
    out = blocked_attention(*to, causal=True, q_offset=m, kv_block=kv_block)
    return np.array(out.astype(jnp.float32))


@pytest.mark.parametrize("arch", sorted(HEADS))
@pytest.mark.parametrize("m,S", CASES)
def test_offset_ref_matches_jax_padded(arch, m, S):
    H, K, d = HEADS[arch]
    q, k, v = _case(m * 7 + S, m, S, H, K, d, torch.float32)
    pad_to = 64 * (-(-(m + S) // 64) + 1)
    kp, vp = _pad(k, pad_to), _pad(v, pad_to)
    want = _jax(q, kp, vp, m, pad_to, jnp.float32)
    for kk, vv in ((k, v), (kp, vp)):
        got = flash_attention_ref(q, kk, vv, q_offset=m)
        assert got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # on the CPU the wrapper runs the plain version
    assert torch.equal(flash_attention(q, k, v, q_offset=m),
                       flash_attention_ref(q, k, v, m))


@pytest.mark.parametrize("arch", sorted(HEADS))
@pytest.mark.parametrize("m,S", CASES)
def test_offset_mirror_matches_jax_bf16(arch, m, S):
    H, K, d = HEADS[arch]
    q, k, v = _case(m * 5 + S + d, m, S, H, K, d, torch.bfloat16)
    got = flash_attention_bf16_mirror_ref(q, k, v, q_offset=m)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    T = 64 * -(-(m + S) // 64)
    want = _jax(q, _pad(k, T), _pad(v, T), m, 64, jnp.bfloat16)
    if d == 64:
        excess = bf16_excess(torch.from_numpy(want), got)
        assert excess <= MIRROR_ATOL, excess
    else:
        err = np.abs(got.float().numpy() - want).max()
        assert err <= bf16_step(torch.from_numpy(want)).max().item(), err
    f32 = flash_attention_ref(q.float(), k.float(), v.float(), q_offset=m)
    assert (got.float() - f32).abs().max().item() <= 1e-2


@pytest.mark.parametrize("m,S", CASES)
def test_offset_mirror_rows_equal_offset_zero_rows(m, S):
    """Rows at offset m are rows m.. of the whole prompt's offset-0 call
    over the same keys, bit for bit, and zero-padded keys change nothing:
    the property the reference's fixed `pad_to` width buys."""
    H, K, d = HEADS["dsr1d"]
    rng = np.random.default_rng(m + S)
    q_all = torch.from_numpy(rng.standard_normal((2, m + S, H, d)).astype(
        np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((2, m + S, K, d)).astype(
        np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((2, m + S, K, d)).astype(
        np.float32)).to(torch.bfloat16)
    whole = flash_attention_bf16_mirror_ref(q_all, k, v)
    suffix = flash_attention_bf16_mirror_ref(q_all[:, m:], k, v, q_offset=m)
    assert torch.equal(suffix, whole[:, m:])
    padded = flash_attention_bf16_mirror_ref(
        q_all[:, m:], _pad(k, m + S + 70), _pad(v, m + S + 70), q_offset=m)
    assert torch.equal(padded, suffix)


def test_negative_offset_raises():
    q, k, v = _case(0, 4, 4, 2, 1, 16, torch.float32)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, v, q_offset=-1)
