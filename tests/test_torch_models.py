"""Parity of the port's decoder (`repro_torch.models`) with the JAX
reference on the CPU: the same weights (carried across by
`repro_torch.params.from_jax_params`), prefill of ragged prompts into a
paged cache, then five greedy `decode_step_paged` steps. Logits must agree
within 1e-4 absolute (float32 matrix products and softmaxes taken in
another order) and every argmax must be equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import build_model
from repro.models.transformer import init_paged_cache as jax_init_paged
from repro.models.transformer import \
    write_prefill_to_pages as jax_write_pages
import repro_torch.configs as tconfigs
from repro_torch.models import (DecoderLM, init_paged_cache,
                                write_prefill_to_pages)
from repro_torch.params import from_jax_params, init_params, param_specs

ARCHS = ["dsr1d-qwen-1.5b", "gpt2-xl"]
ATOL = 1e-4


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg = reduced(get_arch(request.param), layers=2)
    tcfg = tconfigs.reduced(tconfigs.get_arch(request.param), layers=2)
    jm = build_model(cfg, compute_dtype=jnp.float32, remat="none")
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu")
    tm = DecoderLM(tcfg, compute_dtype=torch.float32, device="cpu")
    return cfg, tcfg, jm, jparams, tm, tparams


@pytest.mark.parametrize("name", ARCHS + ["tinyllama-1.1b"])
def test_configs_are_copies_of_the_reference(name):
    if name not in tconfigs.list_archs():
        with pytest.raises(KeyError):
            tconfigs.get_arch(name)
        return
    assert dataclasses.asdict(tconfigs.get_arch(name)) == \
        dataclasses.asdict(get_arch(name))
    assert dataclasses.asdict(tconfigs.reduced(tconfigs.get_arch(name))) \
        == dataclasses.asdict(reduced(get_arch(name)))


def test_param_specs_match_the_reference_template(pair):
    cfg, tcfg, jm, jparams, _, _ = pair
    jshapes = jax.tree.map(lambda x: tuple(x.shape), jparams)

    def shapes(spec):
        if isinstance(spec, dict):
            return {k: shapes(v) for k, v in spec.items()}
        if isinstance(spec, list):
            return [shapes(v) for v in spec]
        return tuple(spec[0])

    assert shapes(param_specs(tcfg)) == jshapes
    drawn = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), drawn) == jshapes


def test_from_jax_params_rejects_a_wrong_shape(pair):
    _, tcfg, _, jparams, _, _ = pair
    bad = jax.device_get(jparams)
    bad = dict(bad, final_norm={k: np.zeros(3, np.float32)
                                for k in bad["final_norm"]})
    with pytest.raises(ValueError):
        from_jax_params(bad, tcfg, device="cpu")


def test_prefill_and_paged_decode_match_jax(pair):
    cfg, tcfg, jm, jparams, tm, tparams = pair
    rng = np.random.default_rng(3)
    ps, P, N = 8, 6, 24
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (17, 9)]
    jcache = jax_init_paged(cfg, 3, N, ps, P, dtype=jnp.float32)
    tcache = init_paged_cache(tcfg, 3, N, ps, P, dtype=torch.float32,
                              device="cpu")
    next_tok = np.zeros((3, 1), np.int64)
    jprefill = jax.jit(jm.prefill, static_argnums=2)
    jdecode = jax.jit(jm.decode_step_paged, static_argnames="attn_backend")
    first_page = 1
    for slot, prompt in zip((1, 2), prompts):     # slot 0 stays inactive
        npg = -(-len(prompt) // ps)
        pages = np.arange(first_page, first_page + npg, dtype=np.int32)
        first_page += npg + 1
        jl, jd = jprefill(jparams, {"tokens": jnp.asarray(prompt[None])},
                          npg * ps)
        tl, td = tm.prefill(tparams, {"tokens": torch.from_numpy(
            prompt[None])}, npg * ps)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(td["slots"][0]["k"].numpy(),
                                   np.asarray(jd["slots"][0]["k"]),
                                   atol=ATOL, rtol=0)
        jcache = jax_write_pages(cfg, jcache, jd, slot, jnp.asarray(pages))
        write_prefill_to_pages(tcfg, tcache, td, slot,
                               torch.from_numpy(pages))
        # later decode steps grow each slot by one page
        jcache["page_table"] = jcache["page_table"].at[slot, npg].set(
            first_page - 1)
        tcache["page_table"][slot, npg] = first_page - 1
        next_tok[slot, 0] = int(np.argmax(np.asarray(jl)[0, -1]))
        assert int(torch.argmax(tl[0, -1])) == next_tok[slot, 0]
    np.testing.assert_array_equal(tcache["page_table"].numpy(),
                                  np.asarray(jcache["page_table"]))
    for _ in range(5):
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(next_tok, jnp.int32),
                             attn_backend="ref")
        tl, tcache = tm.decode_step_paged(tparams, tcache,
                                          torch.from_numpy(next_tok))
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy()[1:], jl[1:], atol=ATOL, rtol=0)
        np.testing.assert_array_equal(tl.argmax(-1).numpy()[1:],
                                      jl.argmax(-1)[1:])
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        next_tok = jl.argmax(-1).astype(np.int64)
    pool = tcache["slots"][0]["kp"].numpy()
    jpool = np.asarray(jcache["slots"][0]["kp"])
    np.testing.assert_allclose(pool[:, 1:], jpool[:, 1:], atol=ATOL, rtol=0)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tconfigs.reduced(tconfigs.get_arch("gpt2-xl"), layers=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecoderLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_paged_cache(cfg, 2, 4, 8, 2)
