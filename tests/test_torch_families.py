"""Parity of the port's decoder families with the JAX reference on the CPU:

* `param_specs` leaf for leaf (path, shape, initialiser) against the
  reference's `lm_template`, for every decoder config, full and reduced;
  `init_params` draws those shapes;
* `local_attention` and `chunked_attention` against the reference's (1e-5);
* `DecoderLM.prefill` (the dense cache, ring rows of local and chunked
  layers included, recurrent states and conv buffers) and three
  `decode_step`s for olmoe, llama4-scout, mamba2, recurrentgemma and
  internvl2 (with prefix embeddings): logits within 1e-4, the caches
  within 1e-5 (scan states 1e-5 relative), greedy tokens equal;
* `build_model` and `concrete_batch`: seamless builds an `EncDecModel`
  with a frames batch, and `DecoderLM` refuses it.

The reference's weights cross through `from_jax_params`; inputs come from
`np.random.default_rng`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, list_archs, reduced
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models.common import PTpl
from repro.models.transformer import lm_template
import repro_torch.configs as tconfigs
from repro_torch.models import (DecoderLM, EncDecModel, build_model,
                                concrete_batch)
from repro_torch.models.attention import chunked_attention, local_attention
from repro_torch.params import from_jax_params, init_params, param_specs

ATOL = 1e-5
LOGIT_ATOL = 1e-4
DECODERS = [n for n in list_archs() if not get_arch(n).is_encdec]
FAMILIES = ["olmoe-1b-7b", "llama4-scout-17b-a16e", "mamba2-130m",
            "recurrentgemma-2b", "internvl2-2b"]


def _ref_leaves(tree, path=()):
    if isinstance(tree, PTpl):
        assert tree.scale == 1.0 and tree.dtype == "float32"
        return {path: (tuple(tree.shape), tree.init)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_ref_leaves(v, path + (k,)))
    return out


def _port_leaves(tree, path=()):
    if isinstance(tree, tuple):
        return {path: (tuple(tree[0]), tree[1])}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, path + (k,)))
    return out


@pytest.mark.parametrize("name", DECODERS)
def test_param_specs_are_the_references_template(name):
    for cfg, tcfg in ((get_arch(name), tconfigs.get_arch(name)),
                      (reduced(get_arch(name)),
                       tconfigs.reduced(tconfigs.get_arch(name)))):
        assert _port_leaves(param_specs(tcfg)) == \
            _ref_leaves(lm_template(cfg))
    tcfg = tconfigs.reduced(tconfigs.get_arch(name))
    params = init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")

    def shapes(t):
        if isinstance(t, torch.Tensor):
            return tuple(t.shape)
        return ({k: shapes(v) for k, v in t.items()} if isinstance(t, dict)
                else [shapes(v) for v in t])

    def spec_shapes(t):
        if isinstance(t, tuple):
            return tuple(t[0])
        return ({k: spec_shapes(v) for k, v in t.items()}
                if isinstance(t, dict) else [spec_shapes(v) for v in t])

    assert shapes(params) == spec_shapes(param_specs(tcfg))


J_WINDOWED = {"local": jax.jit(jattn.local_attention, static_argnums=3),
              "chunked": jax.jit(jattn.chunked_attention, static_argnums=3)}


@pytest.mark.parametrize("kind", ["local", "chunked"])
@pytest.mark.parametrize("S,W,H,K", [(64, 16, 4, 2), (48, 16, 2, 1),
                                     (24, 64, 4, 4)])
def test_windowed_attention_matches_jax(kind, S, W, H, K):
    rng = np.random.default_rng(S * W + H)
    q = rng.standard_normal((2, S, H, 8)).astype(np.float32)
    k = rng.standard_normal((2, S, K, 8)).astype(np.float32)
    v = rng.standard_normal((2, S, K, 8)).astype(np.float32)
    tf = local_attention if kind == "local" else chunked_attention
    want = np.asarray(J_WINDOWED[kind](*map(jnp.asarray, (q, k, v)), W))
    got = tf(*map(torch.from_numpy, (q, k, v)), W).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _leaves(cache):
    """The cache's tensors in the reference's flattening order (slots
    then tail, dict keys sorted)."""
    out = []
    for e in cache["slots"] + cache["tail"]:
        out += [e[k] for k in sorted(e)]
    return out


@pytest.mark.parametrize("name,seq", [
    ("olmoe-1b-7b", 24), ("llama4-scout-17b-a16e", 128),
    ("mamba2-130m", 64), ("recurrentgemma-2b", 128),
    ("internvl2-2b", 20)])
def test_prefill_and_decode_match_jax(name, seq):
    """Windowed configs prefill 128 tokens into rings of 64 rows (the ring
    write of the last 64 positions), then decode past them."""
    cfg = reduced(get_arch(name))
    tcfg = tconfigs.reduced(tconfigs.get_arch(name))
    jm = jax_build_model(cfg, compute_dtype=jnp.float32, remat="none")
    jparams = jm.init(jax.random.PRNGKey(5))
    tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu")
    tm = DecoderLM(tcfg, compute_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(seq)
    toks = rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    cache_len = seq + 8
    if cfg.frontend is not None:
        pe = rng.standard_normal(
            (2, cfg.frontend.num_prefix_tokens, cfg.d_model)).astype(
            np.float32)
        jb["prefix_embeds"] = jnp.asarray(pe)
        tb["prefix_embeds"] = torch.from_numpy(pe)
        cache_len += cfg.frontend.num_prefix_tokens
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(jparams, jb, cache_len)
    tl, tc = tm.prefill(tparams, tb, cache_len)
    jdecode = jax.jit(jm.decode_step)
    for step in range(4):
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), jl.argmax(-1))
        assert tc["pos"] == int(jc["pos"])
        want = jax.tree_util.tree_leaves((jc["slots"], jc["tail"]))
        got = _leaves(tc)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape
            err = np.abs(g.numpy() - w).max()
            assert err <= ATOL * max(1.0, np.abs(w).max()), err
        if step == 3:
            break
        tok = jl.argmax(-1).astype(np.int32)
        jl, jc = jdecode(jparams, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(tok))


def test_build_model_and_concrete_batch():
    for name in FAMILIES:
        cfg = tconfigs.reduced(tconfigs.get_arch(name))
        m = build_model(cfg, compute_dtype=torch.float32, device="cpu")
        assert isinstance(m, DecoderLM) and m.cfg is cfg
        b = concrete_batch(cfg, "train", 2, 24,
                           torch.Generator().manual_seed(1))
        n_pfx = cfg.frontend.num_prefix_tokens if cfg.frontend else 0
        assert b["tokens"].shape == (2, 24 - n_pfx)
        assert (b["labels"] == b["tokens"]).all()
        assert int(b["tokens"].max()) < cfg.vocab_size
        if n_pfx:
            assert b["prefix_embeds"].shape == (2, n_pfx, cfg.d_model)
            assert b["prefix_embeds"].dtype == torch.bfloat16
        else:
            assert "prefix_embeds" not in b
    # seamless builds its encoder-decoder with a frames batch; the
    # decoder-only model still refuses it
    seamless = tconfigs.reduced(tconfigs.get_arch("seamless-m4t-large-v2"))
    m = build_model(seamless, compute_dtype=torch.float32, device="cpu")
    assert isinstance(m, EncDecModel) and m.cfg is seamless
    b = concrete_batch(seamless, "prefill", 1, 8)
    assert b["frames"].shape == (1, 8, seamless.d_model)
    assert b["tokens"].shape == (1, 8) and "labels" not in b
    assert "decoder" in param_specs(seamless)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        DecoderLM(seamless, device="cpu")
