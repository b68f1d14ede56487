"""Parity of the port's paged batcher (`repro_torch.serve`) with the JAX
reference on the CPU: one seeded stream of six ragged requests through both
batchers, with the same weights, must give exactly the same greedy tokens,
occupancy-trace events, `PagedStats` counters and `AccessStats`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import build_model
from repro.serve import PagedContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
import repro_torch.configs as tconfigs
from repro_torch.models import DecoderLM
from repro_torch.params import from_jax_params
from repro_torch.serve import (OutOfPages, PageAllocator,
                               PagedContinuousBatcher, PagedStats, Request)

GEOMETRY = dict(num_slots=2, page_size=8, num_pages=32, max_pages_per_slot=8,
                chunk_steps=4)


def _stream(vocab, seed=0):
    """Ragged prompts (partial last pages) from three lengths, so the
    reference compiles three prefills, not six."""
    rng = np.random.default_rng(seed)
    lengths = rng.choice([7, 17, 30], 6)
    budgets = rng.integers(3, 14, 6)
    return [(rng.integers(0, vocab, int(n)), int(k))
            for n, k in zip(lengths, budgets)]


@pytest.fixture(scope="module", params=["dsr1d-qwen-1.5b", "gpt2-xl"])
def served(request):
    cfg = reduced(get_arch(request.param), layers=2)
    tcfg = tconfigs.reduced(tconfigs.get_arch(request.param), layers=2)
    jm = build_model(cfg, compute_dtype=jnp.float32, remat="none")
    jparams = jm.init(jax.random.PRNGKey(1))
    tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu")
    tm = DecoderLM(tcfg, compute_dtype=torch.float32, device="cpu")
    jb = JaxBatcher(jm, jparams, attn_backend="ref", **GEOMETRY)
    tb = PagedContinuousBatcher(tm, tparams, **GEOMETRY)
    stream = _stream(cfg.vocab_size)
    # the third request stops at EOS: its id is the fourth token the port
    # emits for it alone (the token test below holds both batchers to it)
    probe = PagedContinuousBatcher(tm, tparams, **GEOMETRY)
    probe.submit(Request(rid=0, tokens=stream[2][0], max_new_tokens=6))
    eos = probe.run()[0].output[3]
    for i, (prompt, budget) in enumerate(stream):
        e = eos if i == 2 else None
        jb.submit(JaxRequest(rid=i, tokens=prompt, max_new_tokens=budget,
                             eos_id=e))
        tb.submit(Request(rid=i, tokens=prompt, max_new_tokens=budget,
                          eos_id=e))
    jdone = sorted(jb.run(), key=lambda r: r.rid)
    tdone = sorted(tb.run(), key=lambda r: r.rid)
    return jb, tb, jdone, tdone


def test_greedy_tokens_are_identical(served):
    jb, tb, jdone, tdone = served
    assert [r.rid for r in tdone] == list(range(6))
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert len(tdone[2].output) <= 4          # retired at EOS
    assert [r.finished_s for r in tdone] == [r.finished_s for r in jdone]


def test_occupancy_trace_events_are_identical(served):
    jb, tb, _, _ = served
    jt, tt = jb.ledger.trace, tb.ledger.trace
    assert tt.ev_times == jt.ev_times
    assert tt.ev_dneeded == jt.ev_dneeded
    assert tt.ev_dobsolete == jt.ev_dobsolete
    assert tt.capacity == jt.capacity
    assert tt.peak_needed() > 0 and tt.as_arrays()[1][-1] == 0
    jbundle, tbundle = jb.occupancy_bundle(), tb.occupancy_bundle()
    assert tbundle.total_time == jbundle.total_time
    assert tbundle.graph_name == jbundle.graph_name


def test_paged_stats_are_identical(served):
    jb, tb, _, _ = served
    fields = PagedStats.__dataclass_fields__
    assert {f: getattr(tb.stats, f) for f in fields} == \
        {f: getattr(jb.stats, f) for f in fields}
    assert tb.stats.pages_freed == tb.stats.pages_allocated > 0
    assert tb.ledger.allocator.n_allocated == 0


def test_access_stats_are_identical(served):
    jb, tb, _, _ = served
    assert tb.access.reads_bytes == jb.access.reads_bytes
    assert tb.access.writes_bytes == jb.access.writes_bytes
    assert tb.access.n_reads("kv") == jb.access.n_reads("kv")


def test_unported_options_raise():
    cfg = tconfigs.reduced(tconfigs.get_arch("gpt2-xl"), layers=2)
    m = DecoderLM(cfg, compute_dtype=torch.float32, device="cpu")
    for kw in (dict(prefix_cache=True), dict(prefill_chunk_tokens=8),
               dict(speculate_k=2, kv_dtype="int8"), dict(telemetry=object()),
               dict(meter=object())):
        with pytest.raises(NotImplementedError):
            PagedContinuousBatcher(m, {}, **kw, **GEOMETRY)
    with pytest.raises(NotImplementedError, match="int8"):
        PagedContinuousBatcher(m, {}, speculate_k=2, kv_dtype="int8",
                               **GEOMETRY)
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedContinuousBatcher(m, {}, kv_dtype="int4", **GEOMETRY)
    tb = PagedContinuousBatcher(m, {}, **GEOMETRY)
    with pytest.raises(NotImplementedError):
        tb.submit(Request(rid=0, tokens=np.arange(4), priority=1))
    with pytest.raises(OutOfPages):
        tb.submit(Request(rid=1, tokens=np.arange(70), max_new_tokens=1))


def test_allocator_never_hands_out_the_null_page():
    a = PageAllocator(5)
    pages = a.alloc(4)
    assert sorted(pages) == [1, 2, 3, 4]
    with pytest.raises(OutOfPages):
        a.alloc(1)
    a.free(pages[:2])
    with pytest.raises(ValueError):
        a.free(pages[:1])
