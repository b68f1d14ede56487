"""Parity of the port's dense serving with the JAX reference on the CPU,
where `kernels.gqa_decode` runs its plain PyTorch version.

* the `gqa_decode` plain version against the JAX oracle and the Pallas
  kernel in interpret mode (2e-5), also through the transposed (B, K, T, d)
  view of a (B, T, K, d) cache, the layout the decode step hands it;
* `DecoderLM.decode_step` logits against JAX's over several steps (1e-4),
  including steps past the cache, where the write clamps to the last row;
* `BatchedServer` greedy tokens and logits, and `ContinuousBatcher` tokens,
  trace events, `AccessStats` and `SchedulerStats`, equal to JAX's;
* the KV geometry helpers equal the reference's, and dense greedy tokens
  equal the port's paged greedy tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.kernels.gqa_decode import gqa_decode as jax_gqa_decode
from repro.models import build_model
from repro.serve import BatchedServer as JaxServer
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve.scheduler import kv_bytes_at as jax_kv_bytes_at
from repro.serve.scheduler import kv_slot_budget as jax_kv_slot_budget
from repro.serve.scheduler import slot_state_bytes as jax_slot_state_bytes
import repro_torch.configs as tconfigs
from repro_torch.kernels.gqa_decode import gqa_decode, gqa_decode_ref
from repro_torch.models import DecoderLM, init_cache
from repro_torch.models.attention import decode_valid_mask
from repro_torch.obs import BankEnergyMeter, Telemetry
from repro_torch.params import from_jax_params
from repro_torch.serve import (BatchedServer, ContinuousBatcher,
                               PagedContinuousBatcher, Request,
                               SchedulerStats, ServeConfig, kv_bytes_at,
                               kv_slot_budget, slot_state_bytes)

ATOL = 2e-5
LOGIT_ATOL = 1e-4
ARCHS = ["dsr1d-qwen-1.5b", "gpt2-xl"]


@pytest.mark.parametrize("B,H,K,d,T", [(3, 4, 4, 32, 16), (2, 8, 2, 64, 40),
                                       (4, 12, 2, 16, 24)])
def test_gqa_decode_plain_version_matches_jax(B, H, K, d, T):
    rng = np.random.default_rng(B * T + H)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    k = rng.standard_normal((B, K, T, d)).astype(np.float32)
    v = rng.standard_normal((B, K, T, d)).astype(np.float32)
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    lens[0] = T
    args = list(map(torch.from_numpy, (q, k, v, lens)))
    got = gqa_decode(*args).numpy()
    np.testing.assert_array_equal(got, gqa_decode_ref(*args).numpy())
    for backend in ("ref", "interpret"):
        want = np.asarray(jax_gqa_decode(*map(jnp.asarray, (q, k, v, lens)),
                                         backend=backend, block_t=8))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the decode step's layout: a (B, T, K, d) cache seen as (B, K, T, d)
    kt = torch.from_numpy(k.transpose(0, 2, 1, 3).copy()).transpose(1, 2)
    vt = torch.from_numpy(v.transpose(0, 2, 1, 3).copy()).transpose(1, 2)
    assert not kt.is_contiguous()
    np.testing.assert_allclose(gqa_decode(args[0], kt, vt, args[3]).numpy(),
                               want, atol=ATOL, rtol=0)


def test_valid_mask_is_the_references():
    from repro.models.attention import decode_valid_mask as jax_mask
    for pos in (0, 5, 15, 16, 40):
        np.testing.assert_array_equal(decode_valid_mask("full", 16, pos),
                                      np.asarray(jax_mask("full", 16, pos)))
        # the rings of sliding-window and chunked layers (window 16)
        for kind in ("local", "chunked"):
            np.testing.assert_array_equal(
                decode_valid_mask(kind, 16, pos, 16),
                np.asarray(jax_mask(kind, 16, pos, 16)))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg = reduced(get_arch(request.param), layers=2)
    tcfg = tconfigs.reduced(tconfigs.get_arch(request.param), layers=2)
    jm = build_model(cfg, compute_dtype=jnp.float32, remat="none")
    jparams = jm.init(jax.random.PRNGKey(2))
    tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu")
    tm = DecoderLM(tcfg, compute_dtype=torch.float32, device="cpu")
    return cfg, tcfg, jm, jparams, tm, tparams


def test_decode_step_matches_jax_past_the_cache(pair):
    """Prefill 11 tokens into a 16-row cache, then 8 greedy steps: the last
    three write past the cache (row 15 is overwritten) and attend all 16
    rows, in both packages."""
    cfg, tcfg, jm, jparams, tm, tparams = pair
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 11))
    jl, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(prompt)}, 16)
    tl, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(prompt)}, 16)
    jdecode = jax.jit(jm.decode_step)
    tok = np.asarray(jl).argmax(-1)
    for _ in range(8):
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(tok, jnp.int32))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(tok))
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), jl.argmax(-1))
        assert tcache["pos"] == int(jcache["pos"])
        tok = jl.argmax(-1)
    assert tcache["pos"] == 19
    np.testing.assert_allclose(tcache["slots"][0]["k"].numpy(),
                               np.asarray(jcache["slots"][0]["k"]),
                               atol=LOGIT_ATOL, rtol=0)
    empty = init_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    assert empty["pos"] == 0
    assert empty["slots"][0]["k"].shape == tcache["slots"][0]["k"].shape


def test_batched_server_matches_jax(pair):
    cfg, tcfg, jm, jparams, tm, tparams = pair
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 9))
    jres = JaxServer(jm, jparams, JaxServeConfig(max_len=24, max_new_tokens=6),
                     collect_logits=True).generate(
        {"tokens": jnp.asarray(prompts, jnp.int32)})
    tres = BatchedServer(tm, tparams, ServeConfig(max_len=24,
                                                  max_new_tokens=6),
                         collect_logits=True).generate({"tokens": prompts})
    np.testing.assert_array_equal(tres["tokens"], np.asarray(jres["tokens"]))
    assert tres["logits"].shape == (3, 6, tcfg.padded_vocab)
    np.testing.assert_allclose(tres["logits"], jres["logits"],
                               atol=LOGIT_ATOL, rtol=0)
    st = tres["stats"]
    assert st.tokens_generated == 18 and st.decode_tokens_per_s > 0
    # temperature > 0 draws from the seeded generator: repeatable, in-vocab
    hot = ServeConfig(max_len=24, max_new_tokens=6, temperature=1.0, seed=3)
    a = BatchedServer(tm, tparams, hot).generate({"tokens": prompts})
    b = BatchedServer(tm, tparams, hot).generate({"tokens": prompts})
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert (a["tokens"] >= 0).all() and (a["tokens"] < cfg.vocab_size).all()


def _dense_stream(vocab, seed=4):
    """Ragged prompts; the third runs past max_len = 24 (18 + 10 tokens)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, n), k)
            for n, k in ((7, 9), (13, 6), (18, 10), (5, 8))]


def test_continuous_batcher_matches_jax(pair):
    cfg, tcfg, jm, jparams, tm, tparams = pair
    stream = _dense_stream(cfg.vocab_size)
    jb = JaxBatcher(jm, jparams, num_slots=2, max_len=24)
    tb = ContinuousBatcher(tm, tparams, num_slots=2, max_len=24)
    for i, (p, k) in enumerate(stream):
        jb.submit(JaxRequest(rid=i, tokens=p, max_new_tokens=k))
        tb.submit(Request(rid=i, tokens=p, max_new_tokens=k))
    jdone = sorted(jb.run(), key=lambda r: r.rid)
    tdone = sorted(tb.run(), key=lambda r: r.rid)
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert [r.finished_s for r in tdone] == [r.finished_s for r in jdone]
    jt, tt = jb.trace, tb.trace
    assert tt.ev_times == jt.ev_times
    assert tt.ev_dneeded == jt.ev_dneeded
    assert tt.capacity == jt.capacity
    assert tt.as_arrays()[1][-1] == 0
    assert tb.access.reads_bytes == jb.access.reads_bytes
    assert tb.access.writes_bytes == jb.access.writes_bytes
    fields = SchedulerStats.__dataclass_fields__
    assert {f: getattr(tb.stats, f) for f in fields} == \
        {f: getattr(jb.stats, f) for f in fields}
    assert tb.occupancy_bundle().total_time == jb.occupancy_bundle().total_time


def test_dense_tokens_equal_paged_tokens(pair):
    _, tcfg, _, _, tm, tparams = pair
    stream = _dense_stream(tcfg.vocab_size, seed=5)[:2]
    dense = ContinuousBatcher(tm, tparams, num_slots=2, max_len=32)
    paged = PagedContinuousBatcher(tm, tparams, num_slots=2, page_size=8,
                                   num_pages=16, max_pages_per_slot=4,
                                   chunk_steps=4)
    for b, cls in ((dense, Request), (paged, Request)):
        for i, (p, k) in enumerate(stream):
            b.submit(cls(rid=i, tokens=p, max_new_tokens=k))
    d = sorted(dense.run(), key=lambda r: r.rid)
    p = sorted(paged.run(), key=lambda r: r.rid)
    assert [r.output for r in d] == [r.output for r in p]


def test_dense_batcher_options():
    tcfg = tconfigs.reduced(tconfigs.get_arch("gpt2-xl"), layers=2)
    tm = DecoderLM(tcfg, compute_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="on_long_prompt"):
        ContinuousBatcher(tm, {}, on_long_prompt="drop")
    tel, meter = Telemetry(enabled=True), BankEnergyMeter(2**20, 4)
    cb = ContinuousBatcher(tm, {}, telemetry=tel, meter=meter)
    assert cb.tel is tel and cb.meter is meter
    with pytest.raises(RuntimeError, match="already bound"):
        BatchedServer(tm, {}, ServeConfig(), telemetry=tel)
    assert BatchedServer(tm, {}, ServeConfig(), meter=meter).meter is meter
    cb = ContinuousBatcher(tm, {}, max_len=8)
    with pytest.raises(ValueError, match="max_len"):
        cb.submit(Request(rid=0, tokens=np.arange(9)))
    cut = ContinuousBatcher(tm, {}, max_len=8, on_long_prompt="truncate")
    req = Request(rid=0, tokens=np.arange(9))
    cut.submit(req)
    assert len(req.tokens) == 8


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("local", [False, True])
def test_kv_geometry_equals_the_references(name, local):
    cfg, tcfg = get_arch(name), tconfigs.get_arch(name)
    if local:        # a sliding-window layer after every full one
        cfg = dataclasses.replace(cfg, block_pattern=("full", "local"),
                                  local_window=64)
        tcfg = dataclasses.replace(tcfg, block_pattern=("full", "local"),
                                   local_window=64)
    assert slot_state_bytes(tcfg) == jax_slot_state_bytes(cfg)
    for pos in (0, 1, 63, 64, 65, 4096):
        for nbytes in (1, 2, 4):
            assert kv_bytes_at(tcfg, pos, nbytes) == \
                jax_kv_bytes_at(cfg, pos, nbytes)
    for hbm in (16e9, 80e9):
        assert kv_slot_budget(tcfg, hbm, 4096) == \
            jax_kv_slot_budget(cfg, hbm, 4096)
