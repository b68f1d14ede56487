"""The plain versions of the redesigned attention kernels against the JAX
reference, on the CPU (the kernels themselves run only on the card: see
`tests/test_torch_kernels.py` and `chip_smoke.py`).

* `flash_attention_bf16_mirror_ref`, the arithmetic of the bf16
  tensor-core prefill kernel, against JAX `blocked_attention` with 64-key
  blocks in bf16. At head dim 64 the scale 1/8 is exact in bf16 and the
  two round the same things (P and the output), so each element lies
  within one bf16 step of JAX's plus MIRROR_ATOL. At head dim 128 JAX
  rounds the query times a bf16 scale (1/sqrt(128) is not one) to bf16,
  which the mirror and kernel do not, and which moves many elements by
  more than their own step: there the mirror is held within one bf16 step
  at the output's largest magnitude. Both are held to `flash_attention_ref`
  in float32 within 1e-2 (the bf16 tolerance); the mirror's rows do not
  depend on the prompt's length, bit for bit.
* `gqa_decode_split_ref`, the split-context decode arithmetic, against the
  JAX oracle and the Pallas kernel in interpret mode within 2e-5 (two
  float32 softmax orders), over empty, boundary, mid-split and past-T
  lengths and the strided view the decode step passes; a sequence's row
  does not depend on the batch it shares, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gqa_decode import gqa_decode as jax_gqa_decode
from repro.models.attention import blocked_attention
from repro_torch.kernels.flash_attention import (
    MIRROR_ATOL, bf16_excess, bf16_step, flash_attention_bf16_mirror_ref,
    flash_attention_ref)
from repro_torch.kernels.gqa_decode import gqa_decode_split_ref

ATOL = 2e-5
BF16_TOL = 1e-2
# (H, K, d): dsr1d's group of 6 and head dim 128, the same group at head
# dim 64, and gpt2-xl's MHA at head dim 64
HEADS = {"dsr1d": (6, 1, 128), "dsr1d-d64": (6, 1, 64), "gpt2": (3, 3, 64)}


def _bf16(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def _prefill(seed, S, H, K, d, B=1):
    rng = np.random.default_rng(seed)
    return _bf16(rng, (B, S, H, d)), _bf16(rng, (B, S, K, d)), _bf16(
        rng, (B, S, K, d))


@pytest.mark.parametrize("arch", sorted(HEADS))
@pytest.mark.parametrize("S", [64, 128, 192])
def test_flash_mirror_matches_jax_blocked(arch, S):
    H, K, d = HEADS[arch]
    q, k, v = _prefill(S + d, S, H, K, d)
    got = flash_attention_bf16_mirror_ref(q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    to_jax = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)]
    want = np.array(blocked_attention(*to_jax, causal=True, kv_block=64)
                      .astype(jnp.float32))
    if d == 64:
        excess = bf16_excess(torch.from_numpy(want), got)
        assert excess <= MIRROR_ATOL, excess
    else:
        err = np.abs(got.float().numpy() - want).max()
        assert err <= bf16_step(torch.from_numpy(want)).max().item(), err
    f32 = flash_attention_ref(q.float(), k.float(), v.float())
    assert (got.float() - f32).abs().max().item() <= BF16_TOL


@pytest.mark.parametrize("S1,S2", [(37, 150), (100, 129)])
def test_flash_mirror_rows_do_not_depend_on_prompt_length(S1, S2):
    H, K, d = HEADS["dsr1d"]
    q, k, v = _prefill(S1, S2, H, K, d, B=2)
    long = flash_attention_bf16_mirror_ref(q, k, v)
    short = flash_attention_bf16_mirror_ref(q[:, :S1], k[:, :S1], v[:, :S1])
    assert torch.equal(long[:, :S1], short)


# lengths: empty, one row, on the 32- and 64-row split boundaries, mid
# split, and past T (the cache's last splits empty for the short ones)
T_CACHE = 128
LENGTHS = [0, 1, 32, 64, 69, 100, T_CACHE + 9]


def _decode_case(seed, H=12, K=2, d=32, B=len(LENGTHS), T=T_CACHE):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    k = rng.standard_normal((B, K, T, d)).astype(np.float32)
    v = rng.standard_normal((B, K, T, d)).astype(np.float32)
    lens = np.asarray(LENGTHS[:B], np.int32)
    return q, k, v, lens


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("split_rows", [32, 64, 256])
def test_gqa_decode_split_ref_matches_jax(backend, split_rows):
    q, k, v, lens = _decode_case(split_rows)
    want = np.asarray(jax_gqa_decode(*map(jnp.asarray, (q, k, v, lens)),
                                     backend=backend, block_t=32))
    args = list(map(torch.from_numpy, (q, k, v, lens)))
    got = gqa_decode_split_ref(*args, split_rows=split_rows).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert not got[0].any(), "length 0 attends nothing"
    # the decode step's layout: a (B, T, K, d) cache seen as (B, K, T, d)
    kt, vt = (torch.from_numpy(x.transpose(0, 2, 1, 3).copy()).transpose(1, 2)
              for x in (k, v))
    assert not kt.is_contiguous()
    strided = gqa_decode_split_ref(args[0], kt, vt, args[3],
                                   split_rows=split_rows).numpy()
    np.testing.assert_allclose(strided, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("split_rows", [32, 64, 256])
def test_gqa_decode_split_ref_is_batch_invariant(split_rows):
    q, k, v, lens = map(torch.from_numpy, _decode_case(7, B=7))
    batch = gqa_decode_split_ref(q, k, v, lens, split_rows=split_rows)
    for b in range(len(lens)):
        one = gqa_decode_split_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                   lens[b:b + 1], split_rows=split_rows)
        assert torch.equal(batch[b:b + 1], one), b
