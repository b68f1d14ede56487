"""Parity of the port's serving telemetry and streamed energy with the JAX
package's on the CPU: `PagedContinuousBatcher(telemetry=, meter=)` with
the prefix cache, chunked prefill and a priority arrival (and on int8 pages,
and speculatively), against the reference batcher on the same prompts and
weights.

The batcher's clock is logical, so everything must be equal: the
registry's `snapshot()`, the span list (name, t0, t1, attrs), `slo_summary()`
and each `Request.timeline`; the meter's `finalize`, `request_energy_j`,
`tenant_energy_j`, `wake_counts` and floor; and the Perfetto events built
from them. Instrumentation only observes: tokens, `PagedStats` and trace
events equal an uninstrumented run's. The speculative case, the dense
batchers' telemetry and the `sim.des.*` / `sim.pss.*` counters are
`test_torch_obs_dense.py` (apart so that each file runs in under a minute
on one core)."""
import numpy as np
import pytest

import repro.obs as jobs
from repro.core.gating import Policy as JPolicy
from repro.serve import PagedContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
import repro_torch.obs as tobs
from repro_torch.core.gating import Policy, evaluate
from repro_torch.serve import PagedContinuousBatcher, PagedStats, Request
from test_torch_sla import GEOMETRY, _assert_same, small  # noqa: F401
from test_torch_traffic import plain

PAGED_COUNTERS = {           # serve.paged.* counter -> the PagedStats field
    "admitted": "admitted", "retired": "finished", "prefills": "prefills",
    "chunks": "chunks", "decode_steps": "decode_steps",
    "pages_allocated": "pages_allocated", "pages_freed": "pages_freed",
    "pages_evicted": "evicted_pages", "cow_splits": "cow_splits",
    "prefix_hits": "prefix_hits",
    "prefix_tokens_reused": "prefix_tokens_reused",
    "preemptions": "preemptions", "prefill_slices": "prefill_slices",
    "spec_rounds": "spec_rounds", "spec_accepted": "accepted_tokens",
    "spec_drafted": "drafted_tokens",
    "spec_rolled_back_pages": "rolled_back_pages"}

CASES = {
    "prefix-chunked-priority": dict(prefix_cache=True,
                                    prefill_chunk_tokens=16, num_pages=24),
    "int8-chunked-priority": dict(kv_dtype="int8", prefill_chunk_tokens=16),
}


def _stream(vocab, seed=3):
    """Five prompts, three sharing a 21-token system prompt (mid-page),
    of 14 to 41 tokens, from two tenants; then a priority-1 arrival."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 21)
    reqs = [(np.concatenate([shared, rng.integers(0, vocab, k)]), n, "a")
            for k, n in ((20, 14), (9, 12), (14, 5))]
    reqs += [(rng.integers(0, vocab, 14), 6, "b"),
             (rng.integers(0, vocab, 33), 5, "b")]
    late = (rng.integers(0, vocab, 12), 6, "c")
    return reqs, late


def _serve(b, R, stream):
    reqs, late = stream
    for i, (p, n, ten) in enumerate(reqs):
        b.submit(R(rid=i, tokens=p, max_new_tokens=n, tenant=ten))
    done = []
    b._admit(done)
    b._decode_chunk(done)
    p, n, ten = late
    b.submit(R(rid=len(reqs), tokens=p, max_new_tokens=n, tenant=ten,
               priority=1))
    return done + b.run()


def _obs_view(b, done, tel, meter):
    end = b.occupancy_bundle().total_time
    res = meter.finalize(end)
    return {
        "snapshot": tel.snapshot(),
        "spans": [(s.name, s.t0, s.t1, s.attrs) for s in tel.spans],
        "slo": plain(b.slo_summary()),
        "timelines": {r.rid: plain(r.timeline) for r in done},
        "meter": (res.e_leak, res.e_sw, res.n_transitions, meter.n_events,
                  meter.request_energy_j(end), meter.tenant_energy_j(end),
                  meter.wake_counts(end), meter.floor_j(end),
                  meter.energy_j(end), meter.stall_s(end)),
    }


def check_instrumented_pair(small, kw):
    """Serve `_stream` through both packages' batchers (`kw` on top of the
    `GEOMETRY`), each with an enabled registry and a meter, and hold every
    observable of the port's to the reference's."""
    cfg = small[0]
    stream = _stream(cfg.vocab_size)
    jtel, ttel = jobs.Telemetry(enabled=True), tobs.Telemetry(enabled=True)
    jm = jobs.BankEnergyMeter(2 * 2**20, 8, policy=JPolicy.conservative())
    tm = tobs.BankEnergyMeter(2 * 2**20, 8, policy=Policy.conservative())
    _, jmodel, jparams, tmodel, tparams = small
    geo = dict(GEOMETRY, **kw)
    jb = JaxBatcher(jmodel, jparams, attn_backend="ref", telemetry=jtel,
                    meter=jm, **geo)
    tb = PagedContinuousBatcher(tmodel, tparams, telemetry=ttel, meter=tm,
                                **geo)
    jdone = _serve(jb, JaxRequest, stream)
    tdone = _serve(tb, Request, stream)
    _assert_same(jb, tb, jdone, tdone)
    got = _obs_view(tb, sorted(tdone, key=lambda r: r.rid), ttel, tm)
    want = _obs_view(jb, sorted(jdone, key=lambda r: r.rid), jtel, jm)
    for key in got:
        assert got[key] == want[key], key

    # what the case exercises, and the counters mirror PagedStats
    c = got["snapshot"]["counters"]
    assert tb.stats.preemptions >= 1
    for name, field in PAGED_COUNTERS.items():
        assert c.get(f"serve.paged.{name}", 0) == getattr(tb.stats, field), \
            name
    if kw.get("prefix_cache"):
        assert tb.stats.prefix_hits >= 1
    if kw.get("kv_dtype") == "int8":
        assert c["quant.dequant_pages"] > 0
    names = {s[0] for s in got["spans"]}
    assert {"request", "decode", "prefill", "preempt",
            "decode_chunk"} <= names

    # the meter is Stage II on the ledger's "kv" trace, bit for bit, and
    # its attribution conserves the live total
    end = tb.occupancy_bundle().total_time
    dur, occ = tb.ledger.trace.occupancy_series(end, use="needed")
    ref = evaluate(dur, occ, capacity=tm.capacity, banks=tm.banks,
                   policy=tm.policy, n_reads=0, n_writes=0, char=tm.char)
    res = tm.finalize(end)
    assert (res.e_leak, res.e_sw, res.n_transitions) == \
        (ref.e_leak, ref.e_sw, ref.n_transitions)
    live = tm.energy_j(end)
    total = sum(tm.request_energy_j(end).values()) + tm.floor_j(end)
    assert abs(total - live) <= 1e-12 * live
    assert all(np.isfinite(r.timeline.energy_j) for r in tdone)

    # the Perfetto export of the run, event for event
    evs = [P.chrome_trace_events(tel, b.occupancy_bundle().traces.values(),
                                 end_time=end, meter=m)
           for P, tel, b, m in ((tobs, ttel, tb, tm), (jobs, jtel, jb, jm))]
    assert evs[0] == evs[1]
    area = tobs.counter_integral(evs[0], "kv occupancy [B]", end * 1e6)
    want = tb.ledger.trace.time_integral(end, use="needed") * 1e6
    assert abs(area - want) <= 1e-9 * want
    return tb


@pytest.mark.parametrize("case", sorted(CASES))
def test_instrumented_paged_batcher_matches_reference(small, case):
    tb = check_instrumented_pair(small, CASES[case])
    assert tb.stats.prefill_slices >= 1


def test_instrumentation_only_observes(small):
    """Tokens, stats and both traces' events of the instrumented run equal
    an uninstrumented run's; a registry bound by one batcher refuses a
    second, and without a registry the SLO summary is empty."""
    cfg = small[0]
    kw = CASES["prefix-chunked-priority"]
    stream = _stream(cfg.vocab_size)
    tel = tobs.Telemetry(enabled=True)
    tm, tparams = small[3:]

    def port(**extra):
        return PagedContinuousBatcher(tm, tparams,
                                      **dict(GEOMETRY, **kw, **extra))
    plain_b = port()
    inst = port(telemetry=tel, meter=tobs.BankEnergyMeter(2**21, 8))
    a = _serve(plain_b, Request, stream)
    b = _serve(inst, Request, stream)
    assert [r.output for r in a] == [r.output for r in b]
    assert all(r.timeline is None for r in a)
    assert plain(plain_b.slo_summary()) == plain(tobs.SLOSummary())
    # every PagedStats field but the SLO percentiles the registry fills
    fields = [f for f in PagedStats.__dataclass_fields__
              if not f.endswith("_s")]
    assert {f: getattr(inst.stats, f) for f in fields} == \
        {f: getattr(plain_b.stats, f) for f in fields}
    for name in ("trace", "logical"):
        x, y = getattr(plain_b.ledger, name), getattr(inst.ledger, name)
        assert (x.ev_times, x.ev_dneeded, x.ev_dobsolete) == \
            (y.ev_times, y.ev_dneeded, y.ev_dobsolete)
    with pytest.raises(RuntimeError, match="already bound"):
        port(telemetry=tel)
    assert inst.stats.ttft_p99_s == inst.slo_summary().ttft_p99_s > 0
