"""Parity of the port's MoE (`repro_torch.models.moe`) with the JAX
reference's `repro/models/moe.py` on the CPU, with the reference's weights
(`DecoderLM.init` → `from_jax_params`) and numpy inputs:

* `capacity` over a grid of token counts, expert counts and factors;
* `apply_moe` output (1e-5) and aux loss on reduced olmoe (top-2) and
  llama4-scout (top-1 with the shared expert), float32;
* the tight-capacity case of the reference's smoke test (factor 0.25,
  top-2), where tokens are dropped: the port drops exactly the (token,
  choice) copies the reference's routing drops;
* tied router probabilities go to the lower expert index, as
  `jax.lax.top_k`.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import build_model
from repro.models.moe import apply_moe as jax_apply_moe
from repro.models.moe import capacity as jax_capacity
import repro_torch.configs as tconfigs
from repro_torch.models.moe import apply_moe, capacity, dispatch, route
from repro_torch.params import from_jax_params

ATOL = 1e-5


def _moe_params(cfg, tcfg, seed):
    jm = build_model(cfg, compute_dtype=jnp.float32, remat="none")
    jparams = jm.init(jax.random.PRNGKey(seed))
    tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu")
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][-1]["ffn"])
    tp = {k: (v[0] if not isinstance(v, dict) else
              {kk: vv[0] for kk, vv in v.items()})
          for k, v in tparams["blocks"][-1]["ffn"].items()}
    return jp, tp


def _configs(name, **moe):
    cfg = reduced(get_arch(name))
    tcfg = tconfigs.reduced(tconfigs.get_arch(name))
    if moe:
        cfg = replace(cfg, moe=replace(cfg.moe, **moe))
        tcfg = replace(tcfg, moe=replace(tcfg.moe, **moe))
    return cfg, tcfg


def _jax_keep(cfg, router, x):
    """The reference's routing and ranking (`repro/models/moe.py`
    apply_moe, up to the spill slot), returned as the kept mask of the
    T * k (token, choice) copies."""
    m = cfg.moe
    T = x.shape[0] * x.shape[1]
    C = jax_capacity(T, cfg)
    xf = x.reshape(T, -1)
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ router, axis=-1)
    _, top_e = jax.lax.top_k(probs, m.top_k)
    eid = top_e.reshape(-1)
    N = eid.shape[0]
    order = jnp.argsort(eid, stable=True)
    hist = jnp.zeros((m.num_experts,), jnp.int32).at[eid].add(1)
    starts = jnp.cumsum(hist) - hist
    rank_sorted = jnp.arange(N, dtype=jnp.int32) - starts[eid[order]]
    pos = jnp.zeros((N,), jnp.int32).at[order].set(rank_sorted)
    return np.asarray(pos < C), np.asarray(top_e)


def test_capacity_grid():
    for name in ("olmoe-1b-7b", "llama4-scout-17b-a16e"):
        for cfg, tcfg in ((get_arch(name), tconfigs.get_arch(name)),
                          _configs(name)):
            for cf in (0.25, 1.0, 1.25, 2.0):
                for k in (1, 2, 8):
                    c = replace(cfg, moe=replace(cfg.moe, capacity_factor=cf,
                                                 top_k=k))
                    tc = replace(tcfg, moe=replace(tcfg.moe,
                                                   capacity_factor=cf,
                                                   top_k=k))
                    for T in (1, 7, 8, 64, 100, 512, 4097):
                        assert capacity(T, tc) == jax_capacity(T, c)


@pytest.mark.parametrize("name,kw,shape", [
    ("olmoe-1b-7b", {}, (2, 16)),
    ("olmoe-1b-7b", {}, (1, 37)),
    ("llama4-scout-17b-a16e", {}, (2, 16)),
    # the reference smoke test's dropping case
    ("olmoe-1b-7b", dict(capacity_factor=0.25, top_k=2), (2, 16))])
def test_apply_moe_matches_jax(name, kw, shape):
    cfg, tcfg = _configs(name, **kw)
    jp, tp = _moe_params(cfg, tcfg, seed=1)
    x = np.random.default_rng(sum(shape)).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    jout, jaux = jax_apply_moe(cfg, jp, jnp.asarray(x))
    tout, taux = apply_moe(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=0)
    # the same copies are kept and dropped
    want_keep, want_e = _jax_keep(cfg, jp["router"], jnp.asarray(x))
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, _, top_e = route(tcfg, tp["router"], xf)
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    _, keep = dispatch(tcfg, top_e, capacity(xf.shape[0], tcfg))
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if kw:                           # the dropping case drops
        assert not keep.all() and float(taux) > 0.0


def test_tied_probabilities_pick_the_lower_expert():
    cfg, tcfg = _configs("olmoe-1b-7b")
    jp, tp = _moe_params(cfg, tcfg, seed=2)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = np.random.default_rng(0).standard_normal(
        (1, 12, cfg.d_model)).astype(np.float32)
    _, want_e = _jax_keep(cfg, jp["router"], jnp.asarray(x))
    _, _, top_e = route(tcfg, tp["router"],
                        torch.from_numpy(x).reshape(12, -1))
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    assert (top_e.numpy() == np.arange(cfg.moe.top_k)).all()
    jout, _ = jax_apply_moe(cfg, jp, jnp.asarray(x))
    tout, _ = apply_moe(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
