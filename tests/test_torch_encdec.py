"""Parity of the port's encoder-decoder (seamless-m4t) with the JAX
reference on the CPU, where kernels 2 and 7 run their plain versions:

* non-causal `flash_attention_ref` (float32) against JAX's
  `flash_attention(causal=False)` run as interpret-mode Pallas, its
  `flash_attention_ref(causal=False)` and `blocked_attention(causal=False)`
  at S == T and S != T (2e-5), and the bf16 mirror against JAX's bf16
  `blocked_attention` in 64-key blocks (one bf16 step, plus MIRROR_ATOL at
  head dim 64); `q_offset` is refused when not causal;
* `param_specs` of seamless against the reference's `encdec_template`;
* `encode`, `prefill` logits and caches (self and cross K/V), and four
  `decode_step` logits of reduced seamless against `EncDecModel` (float32:
  memory, caches and logits within 1e-5 of max(1, |reference|)), greedy
  tokens equal;
* `build_model` / `concrete_batch` of seamless;
* on a card (`gpu`): kernel 2 without its mask, both variants, against
  its plain version at S == T and S != T, ragged lengths included.

The reference's weights cross through `from_jax_params`; inputs come from
`np.random.default_rng`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_flash_ref
from repro.models import build_model as jax_build_model
from repro.models.attention import blocked_attention
from repro.models.common import PTpl
from repro.models.encdec import encdec_template
import repro_torch.configs as tconfigs
from repro_torch.kernels.flash_attention import (
    MIRROR_ATOL, bf16_excess, bf16_step, flash_attention,
    flash_attention_bf16_mirror_ref, flash_attention_ref)
from repro_torch.models import EncDecModel, build_model, concrete_batch
from repro_torch.models.attention import cross_attention
from repro_torch.params import from_jax_params, init_params, param_specs

# non-causal attention, float32 (absolute); the model's memory, caches and
# logits (absolute at most 1, else relative to the reference's magnitude)
ATOL = 2e-5
MODEL_ATOL = 1e-5
# kernel 2 on the card against its float32 plain version (chip_smoke.py's)
CARD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
ARCH = "seamless-m4t-large-v2"
# (S query rows, T keys): cross prefill shapes (S < T), encoders (S == T)
# and ragged lengths
SHAPES = [(16, 128), (24, 24), (64, 64), (5, 77), (33, 64)]
HEADS = {"seamless": (4, 4, 64), "gqa-d128": (6, 2, 128)}


def _case(seed, S, T, H, K, d, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, S, H, d)).astype(np.float32)
    k = rng.standard_normal((2, T, K, d)).astype(np.float32)
    v = rng.standard_normal((2, T, K, d)).astype(np.float32)
    return [torch.from_numpy(x).to(dtype) for x in (q, k, v)]


@pytest.mark.parametrize("arch", sorted(HEADS))
@pytest.mark.parametrize("S,T", SHAPES)
def test_noncausal_ref_matches_jax(arch, S, T):
    H, K, d = HEADS[arch]
    q, k, v = _case(S * 31 + T, S, T, H, K, d, torch.float32)
    got = flash_attention_ref(q, k, v, causal=False)
    heads_major = [jnp.asarray(x.numpy()).transpose(0, 2, 1, 3)
                   for x in (q, k, v)]
    wants = [jax_flash_ref(*heads_major, causal=False)]
    if arch == "seamless":      # interpret-mode Pallas at seamless's heads
        wants.append(jax_flash_attention(*heads_major, causal=False,
                                         backend="interpret"))
    for want in wants:
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want).transpose(0, 2, 1, 3),
                                   atol=ATOL, rtol=0)
    blocked = blocked_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                causal=False, kv_block=T)
    np.testing.assert_allclose(got.numpy(), np.asarray(blocked), atol=ATOL,
                               rtol=0)
    # on the CPU the wrapper and cross attention run the plain version
    assert torch.equal(flash_attention(q, k, v, causal=False), got)
    assert torch.equal(cross_attention(q, k, v), got)
    # a causal call over the same keys differs (S > 1 rows see fewer keys)
    if S > 1 and S == T:
        assert not torch.equal(flash_attention_ref(q, k, v), got)


@pytest.mark.parametrize("arch", sorted(HEADS))
@pytest.mark.parametrize("S,T", [(16, 128), (24, 64), (64, 64)])
def test_noncausal_mirror_matches_jax_bf16(arch, S, T):
    H, K, d = HEADS[arch]
    q, k, v = _case(S * 17 + T + d, S, T, H, K, d, torch.bfloat16)
    got = flash_attention_bf16_mirror_ref(q, k, v, causal=False)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = blocked_attention(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                               for x in (q, k, v)), causal=False, kv_block=64)
    want = np.array(want.astype(jnp.float32))
    if d == 64:
        excess = bf16_excess(torch.from_numpy(want), got)
        assert excess <= MIRROR_ATOL, excess
    else:
        err = np.abs(got.float().numpy() - want).max()
        assert err <= bf16_step(torch.from_numpy(want)).max().item(), err
    f32 = flash_attention_ref(q.float(), k.float(), v.float(), causal=False)
    assert (got.float() - f32).abs().max().item() <= 1e-2
    # ragged keys: the mirror masks keys past T, never padding them in
    r = flash_attention_bf16_mirror_ref(q, k[:, :T - 3], v[:, :T - 3],
                                        causal=False)
    f32r = flash_attention_ref(q.float(), k[:, :T - 3].float(),
                               v[:, :T - 3].float(), causal=False)
    assert (r.float() - f32r).abs().max().item() <= 1e-2


def test_noncausal_refuses_offset():
    q, k, v = _case(0, 4, 8, 2, 1, 16, torch.float32)
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, v, q_offset=2, causal=False)


def _ref_leaves(tree, path=()):
    if isinstance(tree, PTpl):
        return {path: (tuple(tree.shape), tree.init)}
    out = {}
    for k, v in tree.items():
        out.update(_ref_leaves(v, path + (k,)))
    return out


def _port_leaves(tree, path=()):
    if isinstance(tree, tuple):
        return {path: (tuple(tree[0]), tree[1])}
    out = {}
    for k, v in tree.items():
        out.update(_port_leaves(v, path + (k,)))
    return out


def test_param_specs_are_the_references_encdec_template():
    for cfg, tcfg in ((get_arch(ARCH), tconfigs.get_arch(ARCH)),
                      (reduced(get_arch(ARCH)),
                       tconfigs.reduced(tconfigs.get_arch(ARCH)))):
        assert _port_leaves(param_specs(tcfg)) == \
            _ref_leaves(encdec_template(cfg))
    tcfg = tconfigs.reduced(tconfigs.get_arch(ARCH))
    p = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["decoder"]["cross_attn"]["wq"].shape == (
        tcfg.num_layers, tcfg.d_model, tcfg.q_dim)
    assert p["encoder"]["attn"]["wk"].shape[0] == tcfg.encoder_layers


def _models(layers=2):
    cfg = reduced(get_arch(ARCH), layers=layers)
    tcfg = tconfigs.reduced(tconfigs.get_arch(ARCH), layers=layers)
    jm = jax_build_model(cfg, compute_dtype=jnp.float32, remat="none")
    jparams = jm.init(jax.random.PRNGKey(3))
    tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu")
    tm = EncDecModel(tcfg, compute_dtype=torch.float32, device="cpu")
    return cfg, tcfg, jm, jparams, tm, tparams


def _batch(cfg, B, S_enc, S, seed):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, S_enc, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return frames, tokens


def _close(got: torch.Tensor, want, atol):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= atol * max(1.0, np.abs(want).max()), err


def test_encode_prefill_and_decode_match_reference():
    cfg, tcfg, jm, jparams, tm, tparams = _models()
    frames, tokens = _batch(cfg, 2, 24, 7, 11)
    _close(tm.encode(tparams, torch.from_numpy(frames)),
           jm.encode(jparams, jnp.asarray(frames)), MODEL_ATOL)
    cache_len = 16
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, cache_len))(
        jparams, {"frames": jnp.asarray(frames),
                  "tokens": jnp.asarray(tokens)})
    tl, tc = tm.prefill(tparams, {"frames": frames, "tokens": tokens},
                        cache_len)
    _close(tl, jl, MODEL_ATOL)
    for key in ("k", "v", "ck", "cv"):
        _close(tc[key], jc[key], MODEL_ATOL)
    assert tc["pos"] == int(jc["pos"]) == 7
    jdecode = jax.jit(jm.decode_step)
    for step in range(4):
        tok = np.asarray(jl[:, -1].argmax(-1)).astype(np.int32)[:, None]
        assert np.array_equal(tok[:, 0], tl[:, -1].argmax(-1).numpy())
        jl, jc = jdecode(jparams, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(tok))
        _close(tl, jl, MODEL_ATOL)
        _close(tc["k"], jc["k"], MODEL_ATOL)
        assert tc["pos"] == int(jc["pos"]) == 8 + step


def test_decode_past_the_cache_clamps_like_the_reference():
    """A prompt longer than the cache keeps its first cache_len rows, and
    a write past the cache lands on the last row, as the reference's
    clamped `dynamic_update_slice`."""
    cfg, tcfg, jm, jparams, tm, tparams = _models()
    frames, tokens = _batch(cfg, 1, 9, 6, 5)
    jl, jc = jm.prefill(jparams, {"frames": jnp.asarray(frames),
                                  "tokens": jnp.asarray(tokens)}, 4)
    tl, tc = tm.prefill(tparams, {"frames": frames, "tokens": tokens}, 4)
    _close(tl, jl, MODEL_ATOL)
    _close(tc["k"], jc["k"], MODEL_ATOL)
    tok = np.array([[3]], np.int32)
    jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tok))
    tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(tok))
    _close(tl, jl, MODEL_ATOL)
    _close(tc["v"], jc["v"], MODEL_ATOL)


def test_build_model_and_frames_batch():
    tcfg = tconfigs.reduced(tconfigs.get_arch(ARCH))
    m = build_model(tcfg, compute_dtype=torch.float32, device="cpu")
    assert isinstance(m, EncDecModel) and m.cfg is tcfg
    for kind in ("train", "prefill"):
        b = concrete_batch(tcfg, kind, 2, 12,
                           torch.Generator().manual_seed(4))
        assert b["frames"].shape == (2, 12, tcfg.d_model)
        assert b["frames"].dtype == torch.bfloat16
        assert b["tokens"].shape == (2, 12)
        assert ("labels" in b) == (kind == "train")
    params = init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    b = concrete_batch(tcfg, "prefill", 2, 12)
    logits, cache = m.prefill(params, b, 16)
    assert logits.shape == (2, 1, tcfg.padded_vocab)
    assert cache["ck"].shape == (tcfg.num_layers, 2, 12, tcfg.num_kv_heads,
                                 tcfg.head_dim)
    with pytest.raises(ValueError, match="decoder-only"):
        EncDecModel(tconfigs.reduced(tconfigs.get_arch("gpt2-xl")),
                    device="cpu")


@pytest.mark.gpu
def test_noncausal_kernel_matches_plain_version_on_card():
    """Kernel 2 without its mask on the card, the tensor-core (bf16, d 64
    and 128) and CUDA-core (float32) variants, against the float32 plain
    version; the causal call over the same inputs is unchanged by the
    flag (run on a machine with a card: `python -m pytest -m gpu`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for (S, T), (H, K, d), dtype in [
            ((64, 1024), (16, 16, 64), torch.bfloat16),
            ((256, 256), (16, 16, 64), torch.bfloat16),
            ((37, 997), (6, 2, 128), torch.bfloat16),
            ((33, 77), (6, 2, 96), torch.float32),
            ((128, 128), (4, 4, 64), torch.float32)]:
        q, k, v = (x.cuda() for x in _case(S + T, S, T, H, K, d, dtype))
        got = flash_attention(q, k, v, causal=False)
        want = flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=False)
        assert got.dtype == dtype
        err = (got.float() - want).abs().max().item()
        assert err <= CARD_TOL[dtype], (S, T, d, dtype, err)
        if S == T:
            assert torch.equal(flash_attention(q, k, v),
                               flash_attention(q, k, v, causal=True))
