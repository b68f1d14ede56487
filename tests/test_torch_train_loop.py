"""The port's checkpoints and training loop on the CPU:

* a checkpoint written by either package restores in the other: numpy
  trees (float32, int32, float64, uint8), a bfloat16 leaf, and the
  {"params", "opt": AdamWState} tree of a real run, key paths included;
* `prune` and `latest_step` ignore `.tmp_` directories; the
  `AsyncCheckpointer` joins its thread; a shape mismatch raises;
* preemption recovery: a run failed at step 6 and resumed from its
  checkpoint ends with the uninterrupted run's params and losses, bit for
  bit (the reference's `tests/test_substrate.py` does this for JAX), and
  a `TrainLoop` with `fail_at_step` fails, keeps and resumes from the
  same checkpoints as the reference's loop does;
* the training CLI (`python -m repro_torch.launch.train --device cpu`).

Every file goes under pytest's `tmp_path`.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import build_model as jax_build_model
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokens as JaxTokens
from repro.optim import AdamW as JaxAdamW
from repro.optim import AdamWState as JaxAdamWState
from repro.optim import constant as jax_constant
from repro.train import LoopConfig as JaxLoopConfig
from repro.train import TrainLoop as JaxLoop
from repro.train import checkpoint as jckpt
import repro_torch.configs as tconfigs
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.optim import AdamW, AdamWState, constant
from repro_torch.optim.tree import tree_leaves
from repro_torch.params import from_jax_params
from repro_torch.train import LoopConfig, StragglerMonitor, TrainLoop
from repro_torch.train import checkpoint as ckpt

ARCH = "tinyllama-1.1b"


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


def _numpy_tree():
    rng = np.random.default_rng(3)
    return {"a": rng.standard_normal(10).astype(np.float32),
            "b": {"c": rng.integers(0, 9, (3, 4)).astype(np.int32),
                  "d": np.array(7.25, np.float64)},
            "e": [rng.integers(0, 255, 5).astype(np.uint8)]}


def _equal_trees(a, b):
    la, lb = tree_leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_checkpoint_numpy_trees_cross_packages(tmp_path):
    tree = _numpy_tree()
    d1, d2 = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(d1, 3, tree, metadata={"loss": 1.5})
    step, got = jckpt.restore(d1, tree)
    assert step == 3
    _equal_trees(tree, got)
    jckpt.save(d2, 4, tree)
    step, got = ckpt.restore(d2, tree)
    assert step == 4
    _equal_trees(got, tree)
    # byte-identical files either way
    for name in os.listdir(os.path.join(d1, "step_00000003")):
        if name.endswith(".npy"):
            assert np.array_equal(
                np.load(os.path.join(d1, "step_00000003", name)),
                np.load(os.path.join(d2, "step_00000004", name)))


def test_checkpoint_bf16_and_train_state_cross_packages(setup, tmp_path):
    jparams, tparams = setup["jparams"], setup["tparams"]
    topt = AdamW(lr=constant(1e-2))
    tstate = {"params": tparams, "opt": topt.init(tparams),
              "half": torch.arange(6, dtype=torch.float32).to(torch.bfloat16)}
    jstate = {"params": jparams,
              "opt": JaxAdamW(lr=jax_constant(1e-2)).init(jparams),
              "half": jnp.arange(6, dtype=jnp.bfloat16)}
    assert isinstance(tstate["opt"], AdamWState)
    assert isinstance(jstate["opt"], JaxAdamWState)
    d1, d2 = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(d1, 1, tstate)
    _, got = jckpt.restore(d1, jstate)
    for a, b in zip(tree_leaves(tstate), jax.tree.leaves(got)):
        assert a.dtype == torch.bfloat16 or np.dtype(b.dtype) == np.dtype(
            str(a.dtype).replace("torch.", ""))
        assert np.array_equal(a.float().numpy(), np.asarray(b, np.float32))
    jckpt.save(d2, 2, jstate)
    _, got = ckpt.restore(d2, tstate)
    assert isinstance(got["opt"], AdamWState)
    for a, b in zip(tree_leaves(got), tree_leaves(tstate)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_prune_latest_and_async(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"x": torch.zeros(2)}
    for s in (10, 20, 30, 40):
        ckpt.save(d, s, tree)
    os.makedirs(os.path.join(d, "step_00000099.tmp_p0"))
    assert ckpt.latest_step(d) == 40 == jckpt.latest_step(d)
    ckpt.prune(d, keep_last=2)
    assert sorted(os.listdir(d)) == ["step_00000030", "step_00000040",
                                     "step_00000099.tmp_p0"]
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    ac = ckpt.AsyncCheckpointer(d, keep_last=2)
    try:
        ac.save_async(41, {"x": torch.arange(4.0)})
        ac.save_async(42, {"x": torch.arange(4.0)})
    finally:
        ac.wait()
    assert ac._thread is None and ac.last_saved == 42
    assert ckpt.latest_step(d) == 42
    with pytest.raises(AssertionError):
        ckpt.restore(d, {"x": torch.zeros(5)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), tree)


def test_preemption_recovery_bit_exact(tmp_path):
    tcfg = tconfigs.reduced(tconfigs.get_arch(ARCH), layers=2)
    data = SyntheticTokens(DataConfig(vocab_size=tcfg.vocab_size, seq_len=16,
                                      global_batch=4, seed=3))
    opt = AdamW(lr=constant(1e-3))

    def loop(ckdir, fail_at=None):
        m = build_model(tcfg, compute_dtype=torch.float32, device="cpu")
        return TrainLoop(m, opt, data, LoopConfig(total_steps=12,
                                                  ckpt_every=4,
                                                  ckpt_dir=ckdir),
                         fail_at_step=fail_at)

    d1 = str(tmp_path / "uninterrupted")
    out1 = loop(d1).run()
    d2 = str(tmp_path / "preempted")
    failing = loop(d2, fail_at=6)
    with pytest.raises(RuntimeError, match="injected failure at step 6"):
        failing.run()
    assert failing.ckpt._thread is None
    assert ckpt.latest_step(d2) == 4
    out2 = loop(d2).run()
    assert out2["history"][0]["step"] == 4
    for a, b in zip(tree_leaves(out1["params"]), tree_leaves(out2["params"])):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(out1["opt_state"]),
                    tree_leaves(out2["opt_state"])):
        assert torch.equal(a, b)
    l1 = {h["step"]: h["loss"] for h in out1["history"]}
    l2 = {h["step"]: h["loss"] for h in out2["history"]}
    assert all(l1[s] == l2[s] for s in range(4, 12))
    assert sorted(os.listdir(d1)) == ["step_00000004", "step_00000008",
                                      "step_00000012"]


def test_fail_at_step_resumes_as_the_reference_does(setup, tmp_path):
    """The same fault schedule through both loops: each fails at step 3
    after saving step 2, keeps the same checkpoints, and, run again with
    the fault cleared, resumes at step 2 to the end; the history (kept
    across both runs of one loop) lists the same steps (the losses differ:
    each package draws its own weights)."""
    tm = setup["tm"]
    kw = dict(total_steps=5, ckpt_every=2)
    dcfg = dict(vocab_size=tm.cfg.vocab_size, seq_len=16, global_batch=2,
                seed=4)
    runs = {}
    for pkg in ("ref", "port"):
        d = str(tmp_path / pkg)
        if pkg == "ref":
            loop = JaxLoop(setup["jm"], JaxAdamW(lr=jax_constant(1e-3)),
                           JaxTokens(JaxDataConfig(**dcfg)),
                           JaxLoopConfig(ckpt_dir=d, **kw), fail_at_step=3)
        else:
            loop = TrainLoop(tm, AdamW(lr=constant(1e-3)),
                             SyntheticTokens(DataConfig(**dcfg)),
                             LoopConfig(ckpt_dir=d, **kw), fail_at_step=3)
        with pytest.raises(RuntimeError, match="injected failure at step 3"):
            loop.run()
        kept = sorted(os.listdir(d))
        loop.fail_at_step = None
        out = loop.run()
        runs[pkg] = (kept, [h["step"] for h in out["history"]],
                     sorted(os.listdir(d)))
    assert runs["port"] == runs["ref"]
    assert runs["port"][:2] == (["step_00000002"], [0, 1, 2, 2, 3, 4])


def test_straggler_monitor():
    mon = StragglerMonitor(factor=3.0, window=5)
    for i in range(10):
        assert not mon.observe(i, 0.1)
    assert mon.observe(10, 1.0)
    assert mon.flagged == [10]


def test_train_cli_on_cpu(tmp_path, capsys):
    d = str(tmp_path / "cli")
    out = train_cli.main(["--arch", ARCH, "--reduced", "--steps", "4",
                          "--batch", "2", "--seq", "16", "--ckpt-every", "2",
                          "--device", "cpu", "--ckpt-dir", d])
    assert [h["step"] for h in out["history"]] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert ckpt.latest_step(d) == 4
    assert "steps 0..3" in capsys.readouterr().out
