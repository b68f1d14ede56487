"""Losses and gradients of the port's models against the JAX reference on
the CPU, same weights through `from_jax_params`, inputs from numpy seeds:

* `loss` of reduced dsr1d-qwen-1.5b, gpt2-xl, olmoe (its MoE aux loss
  included) and seamless (encoder-decoder) within 1e-5 (relative to the
  loss when it exceeds 1), some labels ignored (-1);
* their gradients (`train.step.value_and_grad`) against `jax.grad` in
  float32: every leaf within 1e-4 of its own largest magnitude (a leaf that
  is zero in the reference is zero within 1e-7), and the params left free
  of autograd state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import build_model as jax_build_model
import repro_torch.configs as tconfigs
from repro_torch.models import build_model
from repro_torch.optim.tree import tree_leaves
from repro_torch.params import from_jax_params
from repro_torch.train.step import value_and_grad

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
LOSS_ARCHS = ["dsr1d-qwen-1.5b", "gpt2-xl", "olmoe-1b-7b",
              "seamless-m4t-large-v2"]


def _setup(name, seed=0):
    cfg = reduced(get_arch(name), layers=2)
    tcfg = tconfigs.reduced(tconfigs.get_arch(name), layers=2)
    jm = jax_build_model(cfg, compute_dtype=jnp.float32, remat="none")
    jparams = jm.init(jax.random.PRNGKey(seed))
    tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu")
    tm = build_model(tcfg, compute_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(seed + 1)
    B, S = 2, 16
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    batch["labels"] = batch["tokens"].copy()
    batch["labels"][0, -3:] = -1
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, 12, cfg.d_model)).astype(np.float32)
    return jm, jparams, tm, tparams, batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", LOSS_ARCHS)
def test_loss_and_grads_match_reference(name):
    jm, jparams, tm, tparams, batch = _setup(name)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jparams,
                                                         _jbatch(batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss = tm.loss(tparams, tb)
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL * max(
        1.0, abs(float(jloss)))
    loss2, grads = value_and_grad(tm.loss, tparams, tb)
    assert float(loss2) == float(loss)
    jg = jax.tree_util.tree_flatten_with_path(jax.device_get(jgrads))[0]
    tg = tree_leaves(grads)
    assert len(jg) == len(tg)
    for (path, want), got in zip(jg, tg):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, path
        err = float(np.abs(got.numpy() - want).max())
        scale = float(np.abs(want).max())
        assert err <= GRAD_RTOL * scale or err <= 1e-7, (
            jax.tree_util.keystr(path), err, scale)
    # the loss leaves its params free of autograd state
    assert not any(p.requires_grad for p in tree_leaves(tparams))
