"""Parity of the port's remaining instrumentation with the JAX package's on
the CPU: the instrumented paged batcher speculating over the prefix cache
(`test_torch_obs_serve.py`'s check), the dense `ContinuousBatcher` (logical
clock: counters, spans, SLO summary, timelines and meter equal) and
`BatchedServer` (wall clock: counters and span names equal, the meter's
square wave balanced), and the process-wide `sim.des.*` / `sim.pss.*`
counters of one DES run and one PSS horizon. The process-wide registries are
read as deltas around each call, never reset or replaced; the two packages
keep separate ones."""
import numpy as np
import pytest

import repro.obs as jobs
import repro.obs.telemetry as jtel_mod
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core.workload import build_graph as jbuild_graph
from repro.serve import BatchedServer as JaxServer
from repro.serve import ContinuousBatcher as JaxDense
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.sim.accelerator import baseline_accelerator as jaccel
from repro.sim.engine import simulate as jsimulate
from repro.sim.pss import simulate_decode as jsimulate_decode
import repro_torch.obs as tobs
import repro_torch.obs.telemetry as ttel_mod
from repro_torch.configs import get_arch, reduced
from repro_torch.core.workload import build_graph
from repro_torch.serve import (BatchedServer, ContinuousBatcher, Request,
                               ServeConfig)
from repro_torch.sim.accelerator import baseline_accelerator
from repro_torch.sim.engine import simulate
from repro_torch.sim.pss import simulate_decode
from test_torch_obs_serve import check_instrumented_pair
from test_torch_sla import small  # noqa: F401
from test_torch_traffic import plain


def test_instrumented_spec_batcher_matches_reference(small):
    tb = check_instrumented_pair(small, dict(
        speculate_k=2, prefix_cache=True, chunk_steps=6, num_pages=48))
    assert tb.stats.spec_rounds > 0 and tb.stats.rolled_back_pages > 0


def _dense_stream(vocab):
    rng = np.random.default_rng(8)
    return [(rng.integers(0, vocab, n), k, t)
            for n, k, t in ((7, 9, "a"), (13, 6, "b"), (18, 10, "a"),
                            (5, 8, None))]


def test_instrumented_dense_batcher_matches_reference(small):
    cfg, jm, jparams, tm, tparams = small
    out = []
    for B, R, O, model, params in ((ContinuousBatcher, Request, tobs, tm,
                                    tparams),
                                   (JaxDense, JaxRequest, jobs, jm, jparams)):
        tel = O.Telemetry(enabled=True)
        meter = O.BankEnergyMeter.from_spec("1,4,0.9,aggressive")
        b = B(model, params, num_slots=2, max_len=24, telemetry=tel,
              meter=meter)
        for i, (p, k, ten) in enumerate(_dense_stream(cfg.vocab_size)):
            b.submit(R(rid=i, tokens=p, max_new_tokens=k, tenant=ten))
        done = sorted(b.run(), key=lambda r: r.rid)
        end = b.occupancy_bundle().total_time
        res = meter.finalize(end)
        out.append({
            "tokens": [r.output for r in done],
            "events": (b.trace.ev_times, b.trace.ev_dneeded),
            "stats": plain(b.stats),
            "snapshot": tel.snapshot(),
            "spans": [(s.name, s.t0, s.t1, s.attrs) for s in tel.spans],
            "slo": plain(b.slo_summary()),
            "timelines": [plain(r.timeline) for r in done],
            "meter": (res.e_leak, res.e_sw, res.n_transitions,
                      meter.request_energy_j(end), meter.tenant_energy_j(end),
                      meter.wake_counts(end), meter.floor_j(end)),
        })
    for key in out[0]:
        assert out[0][key] == out[1][key], key
    c = out[0]["snapshot"]["counters"]
    assert c["serve.dense.retired"] == c["serve.dense.admitted"] == 4
    assert out[0]["slo"]["ttft_p99_s"] > 0 and out[0]["meter"][3]


def test_instrumented_batched_server_matches_reference(small):
    """Wall-clock spans: the counters and the span names and attributes
    equal the reference's; the meter's square wave per call rises at
    prefill, grows over decode and returns to zero."""
    cfg, jm, jparams, tm, tparams = small
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 9))
    out = []
    for S, C, O, model, params in ((BatchedServer, ServeConfig, tobs, tm,
                                    tparams),
                                   (JaxServer, JaxServeConfig, jobs, jm,
                                    jparams)):
        tel = O.Telemetry(enabled=True)
        meter = O.BankEnergyMeter(2**20, 4)
        server = S(model, params, C(max_len=24, max_new_tokens=6),
                   telemetry=tel, meter=meter)
        toks = [server.generate({"tokens": prompts})["tokens"].tolist()
                for _ in range(2)]
        _, n_int, _ = meter.trace.as_arrays()
        out.append((toks, tel.snapshot()["counters"],
                    [(s.name, s.attrs) for s in tel.spans],
                    meter.n_events, meter.trace.ev_dneeded, int(n_int[-1]),
                    sorted(meter.request_energy_j())))
    assert out[0] == out[1]
    assert out[0][1]["serve.engine.tokens_generated"] == 36
    assert [n for n, _ in out[0][2]] == ["prefill", "decode"] * 2


def _sim_delta(registry, run):
    """`run()`'s increments of the process-wide registry's `sim.*`
    counters."""
    def sim_counters():
        return {k: v for k, v in registry().snapshot()["counters"].items()
                if k.startswith("sim.")}
    before = sim_counters()
    run()
    after = sim_counters()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


@pytest.mark.parametrize("memoize", [False, True])
def test_sim_counters_match_reference(memoize):
    """`sim.des.*` of one DES run (memoized and not) and `sim.pss.*` of one
    PSS horizon: the port's deltas on its registry equal the reference's
    on its own."""
    name = "dsr1d-qwen-1.5b"
    t, j = reduced(get_arch(name), layers=2), jreduced(jget_arch(name),
                                                        layers=2)
    got = _sim_delta(ttel_mod.default_registry, lambda: simulate(
        build_graph(t, M=128, subops=2), baseline_accelerator(8),
        memoize_layers=memoize))
    want = _sim_delta(jtel_mod.default_registry, lambda: jsimulate(
        jbuild_graph(j, M=128, subops=2), jaccel(8), memoize_layers=memoize))
    assert got == want and got["sim.des.runs"] == 1
    kw = dict(start_ctx=64, steps=24, batch=2, subops=1)
    got = _sim_delta(ttel_mod.default_registry, lambda: simulate_decode(
        t, baseline_accelerator(32), fidelity="pss", **kw))
    want = _sim_delta(jtel_mod.default_registry, lambda: jsimulate_decode(
        j, jaccel(32), fidelity="pss", **kw))
    assert got == want and got["sim.pss.decode_sims"] == 1
    assert got["sim.pss.probes"] > 0 and got["sim.des.runs"] > 0
