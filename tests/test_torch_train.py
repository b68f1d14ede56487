"""Parity of the port's training pieces with the JAX reference on the CPU:

* `cross_entropy` (with ignored labels) within 1e-5;
* (the losses and gradients of whole models: `test_torch_train_grads.py`)
* `blocked_attention`, the plain attention the losses run, and its
  gradients (autograd) against the reference's jnp `blocked_attention`
  and `jax.grad`, causal and not, with GQA groups, within 2e-5;
* `remat` "none", "full" and "dots" (`models.common.checkpointed`) give
  the same loss and the same gradients bit for bit, on a decoder and on
  the encoder-decoder;
* AdamW (with clipping and weight decay), both schedules and both
  compressions against the reference over 3 steps (rel 1e-6);
* `SyntheticTokens.batch_at` equal to the reference's bit for bit, and the
  `Prefetcher` stopped and joined.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokens as JaxTokens
from repro.models.attention import blocked_attention as jax_blocked
from repro.models.common import cross_entropy as jax_cross_entropy
from repro.optim import AdamW as JaxAdamW
from repro.optim import apply_compression as jax_apply_compression
from repro.optim import constant as jax_constant
from repro.optim import cosine_with_warmup as jax_cosine
from repro.optim import init_error_state as jax_init_error_state
from repro_torch.data import DataConfig, Prefetcher, SyntheticTokens
import repro_torch.configs as tconfigs
from repro_torch.models import build_model, concrete_batch
from repro_torch.models.attention import blocked_attention
from repro_torch.models.common import checkpointed, cross_entropy
from repro_torch.optim import (AdamW, apply_compression, constant,
                               cosine_with_warmup, init_error_state)
from repro_torch.optim.tree import tree_leaves
from repro_torch.params import init_params
from repro_torch.train.step import value_and_grad

LOSS_ATOL = 1e-5
OPT_RTOL = 1e-6
ATTN_ATOL = 2e-5


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = -1
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    assert abs(float(got) - float(want)) <= LOSS_ATOL
    all_ignored = np.full((2, 3), -1, np.int32)
    assert float(cross_entropy(torch.from_numpy(logits[:2, :3]),
                               torch.from_numpy(all_ignored))) == 0.0


@pytest.mark.parametrize("causal,S,T,H,K", [(True, 19, 19, 6, 2),
                                            (False, 7, 33, 4, 4),
                                            (False, 16, 16, 6, 1),
                                            (True, 1, 1, 2, 2)])
def test_blocked_attention_and_grads_match_reference(causal, S, T, H, K):
    rng = np.random.default_rng(S * T + H)
    q, k, v, dout = (rng.standard_normal(s).astype(np.float32)
                     for s in ((2, S, H, 16), (2, T, K, 16), (2, T, K, 16),
                               (2, S, H, 16)))
    ins = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    with torch.enable_grad():
        out = blocked_attention(*ins, causal=causal)
        got = torch.autograd.grad(out, ins, torch.from_numpy(dout))

    def jloss(q, k, v):
        o = jax_blocked(q, k, v, causal=causal, kv_block=T)
        return jnp.sum(o * dout), o
    jgrads, jout = jax.grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATTN_ATOL, rtol=0)
    for g, w in zip(got, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATTN_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "olmoe-1b-7b",
                                  "seamless-m4t-large-v2"])
def test_remat_modes_give_the_same_loss_and_grads(name):
    cfg = tconfigs.reduced(tconfigs.get_arch(name), layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    batch = concrete_batch(cfg, "train", 2, 12,
                           torch.Generator().manual_seed(2))
    if "frames" in batch:
        batch["frames"] = batch["frames"].float()
    runs = [value_and_grad(build_model(cfg, compute_dtype=torch.float32,
                                       remat=r, device="cpu").loss,
                           params, batch)
            for r in ("none", "full", "dots")]
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, b in zip(tree_leaves(grads), tree_leaves(runs[0][1])):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="remat"):
        checkpointed("some", lambda x: x)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_adamw_matches_reference_over_three_steps(schedule):
    rng = np.random.default_rng(5)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32)]}
    grads = [{"a": rng.standard_normal((4, 3)).astype(np.float32) * s,
              "b": [rng.standard_normal(5).astype(np.float32) * s]}
             for s in (0.1, 3.0, 0.5)]        # the middle one is clipped
    if schedule == "constant":
        jopt, topt = JaxAdamW(lr=jax_constant(1e-2)), AdamW(lr=constant(1e-2))
    else:
        jopt = JaxAdamW(lr=jax_cosine(1e-2, 2, 10), weight_decay=0.05)
        topt = AdamW(lr=cosine_with_warmup(1e-2, 2, 10), weight_decay=0.05)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {"a": torch.from_numpy(params["a"]),
          "b": [torch.from_numpy(params["b"][0])]}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = topt.update({"a": torch.from_numpy(g["a"]),
                                  "b": [torch.from_numpy(g["b"][0])]}, ts, tp)
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= OPT_RTOL
        assert _rel(tm["lr"], jm["lr"]) <= OPT_RTOL
    assert int(ts.step) == int(js.step) == 3
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert _rel(a.numpy(), b) <= OPT_RTOL


def test_schedules_match_reference():
    jl, tl = jax_cosine(3e-3, 10, 100), cosine_with_warmup(3e-3, 10, 100)
    for s in (0, 1, 9, 10, 11, 55, 100, 130):
        assert _rel(tl(torch.tensor(s)), jl(jnp.asarray(s))) <= OPT_RTOL
    assert float(constant(0.25)(torch.tensor(7))) == 0.25


@pytest.mark.parametrize("mode", ["bf16", "int8ef"])
def test_compression_matches_reference_over_three_steps(mode):
    rng = np.random.default_rng(9)
    shapes = {"w": (6, 5), "b": (7,)}
    jerr = jax_init_error_state({k: jnp.zeros(s) for k, s in shapes.items()})
    terr = init_error_state({k: torch.zeros(s) for k, s in shapes.items()})
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32) * 10.0 ** -step
             for k, s in shapes.items()}
        jd, jerr = jax_apply_compression(jax.tree.map(jnp.asarray, g), mode,
                                         jerr if mode == "int8ef" else None)
        td, terr = apply_compression({k: torch.from_numpy(v)
                                      for k, v in g.items()}, mode,
                                     terr if mode == "int8ef" else None)
        for k in shapes:
            assert td[k].dtype == (torch.bfloat16 if mode == "bf16"
                                   else torch.float32)
            np.testing.assert_allclose(td[k].float().numpy(),
                                       np.asarray(jd[k], np.float32),
                                       rtol=OPT_RTOL, atol=1e-7)
            if mode == "int8ef":
                np.testing.assert_allclose(terr[k].numpy(),
                                           np.asarray(jerr[k]),
                                           rtol=OPT_RTOL, atol=1e-7)
    g = {"w": torch.ones(2)}
    assert apply_compression(g, "none") == (g, None)
    with pytest.raises(ValueError):
        apply_compression(g, "fp4")


@pytest.mark.parametrize("structured", [True, False])
def test_synthetic_tokens_equal_reference(structured):
    for shard, n in ((0, 1), (1, 2)):
        kw = dict(vocab_size=321, seq_len=24, global_batch=4, seed=7,
                  structured=structured)
        ours = SyntheticTokens(DataConfig(**kw), shard, n)
        ref = JaxTokens(JaxDataConfig(**kw), shard, n)
        for step in (0, 3, 1000):
            a, b = ours.batch_at(step), ref.batch_at(step)
            assert sorted(a) == sorted(b) == ["labels", "tokens"]
            for key in a:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


def test_prefetcher_order_and_stop_joins():
    ds = SyntheticTokens(DataConfig(vocab_size=50, seq_len=8,
                                    global_batch=2))
    pf = Prefetcher(ds, start_step=10)
    try:
        s0, b0 = pf.next()
        s1, _ = pf.next()
    finally:
        pf.stop()
    assert (s0, s1) == (10, 11)
    np.testing.assert_array_equal(b0["tokens"], ds.batch_at(10)["tokens"])
    assert not pf._thread.is_alive()
