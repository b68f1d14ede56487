"""The port's training step against the JAX reference on the CPU:

* three `make_train_step` steps with `microbatches` 1 and 2 against the
  reference's `make_train_step` on the same batches: each step's loss
  within rel 1e-5 and gradient norm within rel 1e-4, the params after
  three steps within 1e-4; with int8 error-feedback compression too,
  whose params are held within 2.5e-3 (a gradient element on a rounding
  boundary of the int8 grid moves by one step, which Adam's normalized
  update turns into up to about lr = 1e-2 in that parameter);
  `make_eval_step` equals the loss and leaves grad mode as it was;

The reference's weights cross through `from_jax_params`; batches come from
the port's `SyntheticTokens` (equal to the reference's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro.optim import constant as jax_constant
from repro.optim import init_error_state as jax_init_error_state
from repro.train.step import make_train_step as jax_make_train_step
import repro_torch.configs as tconfigs
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import build_model
from repro_torch.optim import AdamW, constant, init_error_state
from repro_torch.optim.tree import tree_leaves
from repro_torch.params import from_jax_params
from repro_torch.train import make_eval_step, make_train_step

STEP_RTOL = 1e-4
LOSS_RTOL = 1e-5
LOSS_ATOL = 1e-5
PARAM_ATOL = {"none": 1e-4, "int8ef": 2.5e-3}
ARCH = "tinyllama-1.1b"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def setup():
    """The reference model and params, the port's model with the same
    params, and the data stream, built once for the module."""
    cfg = reduced(get_arch(ARCH), layers=2)
    tcfg = tconfigs.reduced(tconfigs.get_arch(ARCH), layers=2)
    jm = jax_build_model(cfg, compute_dtype=jnp.float32, remat="none")
    jparams = jm.init(jax.random.PRNGKey(1))
    tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu")
    tm = build_model(tcfg, compute_dtype=torch.float32, device="cpu")
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                      global_batch=4, seed=2))
    return dict(jm=jm, jparams=jparams, tm=tm, tparams=tparams, data=data)


@pytest.mark.parametrize("compression", ["none", "int8ef"])
def test_train_step_three_steps_match_reference(setup, compression):
    jm, jparams, tm, tparams = (setup[k] for k in ("jm", "jparams", "tm",
                                                   "tparams"))
    batches = [setup["data"].batch_at(i) for i in range(3)]
    jopt, topt = JaxAdamW(lr=jax_constant(1e-2)), AdamW(lr=constant(1e-2))
    jstep = jax.jit(jax_make_train_step(jm, jopt, compression))
    jstate = [jparams, jopt.init(jparams)]
    if compression == "int8ef":
        jstate.append(jax_init_error_state(jparams))
    jmetrics = []
    for b in batches:
        out = jstep(jstate[0], jstate[1],
                    {k: jnp.asarray(v) for k, v in b.items()}, *jstate[2:])
        jstate = [out[0], out[1], *out[3:]]
        jmetrics.append(out[2])
    for mb in (1, 2):
        step = make_train_step(tm, topt, compression, microbatches=mb)
        state = [tparams, topt.init(tparams)]
        if compression == "int8ef":
            state.append(init_error_state(tparams))
        for b, jmet in zip(batches, jmetrics):
            out = step(state[0], state[1], b, *state[2:])
            state = [out[0], out[1], *out[3:]]
            assert _rel(out[2]["loss"], jmet["loss"]) <= LOSS_RTOL
            assert _rel(out[2]["grad_norm"], jmet["grad_norm"]) <= STEP_RTOL
        assert torch.is_grad_enabled()
        assert int(state[1].step) == int(jstate[1].step) == 3
        for a, b in zip(tree_leaves(state[0]), jax.tree.leaves(jstate[0])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=PARAM_ATOL[compression])
        if compression == "int8ef":
            for a, b in zip(tree_leaves(state[2]),
                            jax.tree.leaves(jstate[2])):
                assert a.shape == b.shape and a.dtype == torch.float32
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    ev = make_eval_step(tm)(tparams, batches[0])
    assert abs(float(ev) - float(jm.loss(jparams, jb))) <= LOSS_ATOL
    assert torch.is_grad_enabled()
