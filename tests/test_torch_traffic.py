"""Parity of the port's model-free traffic simulators (`traffic/occupancy`)
with the JAX package's on the CPU.

The port's `simulate_prefix_traffic` and `simulate_spec_traffic`, built into
the payloads of `tests/golden_util.py` through port modules, reproduce
`prefix_golden.json`, `quant_golden.json` and `spec_golden.json` field for
field (durations bit for bit). `simulate_traffic` on both paper models at
the exact, pss and auto fidelities, and the prefix and speculative
simulators on seeded streams, equal the reference's: trace events, stats,
`utilization_summary`, and a meter streamed alongside."""
import dataclasses

import numpy as np
import pytest

import golden_util
import repro.obs.energy as jenergy
import repro.traffic.generators as jgen
import repro.traffic.occupancy as jocc
from repro.configs import get_arch as jget_arch
import repro_torch.obs.energy as tenergy
import repro_torch.traffic.generators as tgen
import repro_torch.traffic.occupancy as tocc
from repro_torch.configs import get_arch

ARCHS = ("dsr1d-qwen-1.5b", "gpt2-xl")


def plain(x):
    """Dataclasses, histograms and arrays as plain values, so objects of the
    two packages compare by content."""
    if hasattr(x, "edges") and hasattr(x, "counts"):        # Histogram
        return ("hist", list(x.edges), list(x.counts), x.count,
                x.min_value, x.max_value)
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def trace_events(tr):
    return (tr.mem_name, tr.capacity, list(tr.ev_times),
            list(tr.ev_dneeded), list(tr.ev_dobsolete))


def sim_view(sim, occ_mod):
    b = sim.bundle
    return (sim.arch_name, sim.num_slots, b.graph_name, b.total_time,
            {k: trace_events(t) for k, t in b.traces.items()},
            dict(b.access.reads_bytes), dict(b.access.writes_bytes),
            plain(sim.stats), occ_mod.utilization_summary(sim))


def meter_view(m, end):
    res = m.finalize(end)
    return (res.e_leak, res.e_sw, res.n_transitions, m.n_events,
            m.energy_j(end), m.request_energy_j(end), m.tenant_energy_j(end),
            m.floor_j(end), m.wake_counts(end), m.stall_s(end))


# ------------------------------------------------------------ the goldens
def _mems(sim):
    mems = {}
    for m, tr in sim.bundle.traces.items():
        dur, needed, obsolete, _ = tr.segments(sim.total_time)
        _, n_int, o_int = tr.as_arrays()
        mems[m] = {
            "n_events": tr.n_events,
            "peak_needed": int(tr.peak_needed()),
            "peak_total": int(tr.peak_total()),
            "final_needed": int(n_int[-1]) if len(n_int) else 0,
            "final_obsolete": int(o_int[-1]) if len(o_int) else 0,
            "durations": [float(d) for d in dur],
            "needed": [int(v) for v in needed],
            "obsolete": [int(v) for v in obsolete],
        }
    return mems


def _access(sim):
    a = sim.bundle.access
    return ({k: int(v) for k, v in sorted(a.reads_bytes.items())},
            {k: int(v) for k, v in sorted(a.writes_bytes.items())})


def prefix_payload(name, kv_dtype_bytes=2):
    """`golden_util.prefix_case_payload` through the port's modules."""
    spec = golden_util.PREFIX_CASES[name]
    cfg = get_arch(spec["arch"])
    lengths = tgen.LengthModel(max_len=spec["max_len"])
    reqs = tgen.generate_workload(spec["workload"], spec["rate"],
                                  spec["horizon_s"], seed=spec["seed"],
                                  lengths=lengths,
                                  prefix_len=spec["prefix_len"],
                                  sharing=spec["sharing"],
                                  fanout=spec["sharing"])
    sim = tocc.simulate_prefix_traffic(
        cfg, reqs, num_slots=spec["num_slots"], page_size=spec["page_size"],
        max_len=spec["max_len"], kv_dtype_bytes=kv_dtype_bytes,
        seed=spec["seed"])
    st = sim.stats
    reads, writes = _access(sim)
    return {
        "total_time": float(sim.total_time), "n_requests": len(reqs),
        "stats": {k: getattr(st, k) for k in (
            "admitted", "finished", "decode_steps", "prefix_hits",
            "prefix_tokens_reused", "cow_splits", "evicted_pages")},
        "access_reads": reads, "access_writes": writes,
        "mems": _mems(sim)}


def spec_payload(name):
    """`golden_util.spec_case_payload` through the port's modules."""
    spec = golden_util.SPEC_CASES[name]
    cfg = get_arch(spec["arch"])
    lengths = tgen.LengthModel(max_len=spec["max_len"])
    reqs = tgen.generate(spec["arrival"], spec["rate"], spec["horizon_s"],
                         seed=spec["seed"], lengths=lengths)
    sim = tocc.simulate_spec_traffic(
        cfg, reqs, num_slots=spec["num_slots"], page_size=spec["page_size"],
        max_len=spec["max_len"], spec_k=spec["spec_k"],
        acceptance=spec["acceptance"], draft_kv_frac=spec["draft_kv_frac"],
        seed=spec["seed"])
    st = sim.stats
    reads, writes = _access(sim)
    return {
        "total_time": float(sim.total_time), "n_requests": len(reqs),
        "stats": {k: getattr(st, k) for k in (
            "admitted", "finished", "decode_steps", "spec_rounds",
            "drafted_tokens", "accepted_tokens", "rolled_back_pages")},
        "n_neg_deltas": int((np.asarray(sim.trace.ev_dneeded) < 0).sum()),
        "access_reads": reads, "access_writes": writes,
        "mems": _mems(sim)}


def _check(got, want, keys):
    for key in keys:
        assert got[key] == want[key], key
    assert sorted(got["mems"]) == sorted(want["mems"])
    for m, w in want["mems"].items():
        assert got["mems"][m] == w, m
    assert not golden_util.diff_payload(
        dict(got, writebacks=0, total_macs=0, total_vector_ops=0,
             dram_traffic_bytes=0),
        dict(want, writebacks=0, total_macs=0, total_vector_ops=0,
             dram_traffic_bytes=0), time_rtol=0.0)


@pytest.mark.parametrize("case", sorted(golden_util.PREFIX_CASES))
def test_prefix_simulator_reproduces_golden(case):
    _check(prefix_payload(case), golden_util.load_prefix_golden()[case],
           ("total_time", "n_requests", "stats", "access_reads",
            "access_writes"))


@pytest.mark.parametrize("case", sorted(golden_util.QUANT_CASES))
def test_prefix_simulator_reproduces_quant_golden(case):
    base, nbytes = golden_util.QUANT_CASES[case]
    want = golden_util.load_quant_golden()[case]
    assert (want["base_case"], want["kv_dtype_bytes"]) == (base, nbytes)
    _check(prefix_payload(base, kv_dtype_bytes=nbytes), want,
           ("total_time", "n_requests", "stats", "access_reads",
            "access_writes"))


@pytest.mark.parametrize("case", sorted(golden_util.SPEC_CASES))
def test_spec_simulator_reproduces_golden(case):
    _check(spec_payload(case), golden_util.load_spec_golden()[case],
           ("total_time", "n_requests", "stats", "n_neg_deltas",
            "access_reads", "access_writes"))


# ------------------------------------------------ against the reference
def _streams(horizon, max_len=1024, seed=0):
    """The same seeded poisson stream at 4/s from each package."""
    return [G.generate("poisson", 4.0, horizon, seed=seed,
                       lengths=G.LengthModel(max_len=max_len))
            for G in (tgen, jgen)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fidelity", ["exact", "pss", "auto"])
def test_simulate_traffic_matches_reference(arch, fidelity):
    """Trace events, `TrafficStats` (latencies, TBT histogram),
    `utilization_summary` and a streamed meter's results equal the
    reference's; the fast-forward fidelities equal the exact one."""
    treqs, jreqs = _streams(horizon=12.0)
    got, want = [], []
    for occ, E, ga, reqs, out in (
            (tocc, tenergy, get_arch, treqs, got),
            (jocc, jenergy, jget_arch, jreqs, want)):
        m = E.BankEnergyMeter.from_spec("64,8,0.9,conservative")
        sim = occ.simulate_traffic(ga(arch), reqs, num_slots=8,
                                   max_len=1024, fidelity=fidelity, meter=m)
        out.append(sim_view(sim, occ))
        out.append(meter_view(m, sim.total_time))
    assert got == want
    exact = tocc.simulate_traffic(get_arch(arch), treqs, num_slots=8,
                                  max_len=1024, fidelity="exact")
    assert sim_view(exact, tocc)[4] == got[0][4]


@pytest.mark.parametrize("workload,arch", [("chat_sysprompt", ARCHS[0]),
                                           ("agentic_fanout", ARCHS[1]),
                                           ("fewshot", ARCHS[0])])
def test_simulate_prefix_traffic_matches_reference(workload, arch):
    got, want = [], []
    for occ, G, E, ga, out in ((tocc, tgen, tenergy, get_arch, got),
                               (jocc, jgen, jenergy, jget_arch, want)):
        lengths = G.LengthModel(max_len=1024)
        reqs = G.generate_workload(workload, 4.0, 8.0, seed=2,
                                   lengths=lengths, prefix_len=256,
                                   sharing=4, fanout=4)
        m = E.BankEnergyMeter.from_spec("32,8,0.9,drowsy")
        sim = occ.simulate_prefix_traffic(ga(arch), reqs, num_slots=4,
                                          page_size=16, max_len=1024,
                                          seed=2, kv_dtype_bytes=1, meter=m)
        out.append(sim_view(sim, occ))
        out.append(meter_view(m, sim.total_time))
    assert got == want


@pytest.mark.parametrize("k,acc", [(2, 0.3), (4, 0.9)])
def test_simulate_spec_traffic_matches_reference(k, acc):
    treqs, jreqs = _streams(horizon=8.0, max_len=512, seed=1)
    got, want = [], []
    for occ, E, ga, reqs, out in ((tocc, tenergy, get_arch, treqs, got),
                                  (jocc, jenergy, jget_arch, jreqs, want)):
        m = E.BankEnergyMeter.from_spec("32,4,0.9,aggressive")
        sim = occ.simulate_spec_traffic(ga("dsr1d-qwen-1.5b"), reqs,
                                        num_slots=4, page_size=16,
                                        max_len=512, spec_k=k,
                                        acceptance=acc, draft_kv_frac=0.5,
                                        seed=1, meter=m)
        out.append(sim_view(sim, occ))
        out.append(meter_view(m, sim.total_time))
    assert got == want
    assert got[0][8]["finished"] > 0


def test_timing_model_and_validation_match_reference():
    for name in ARCHS:
        assert dataclasses.asdict(tocc.TimingModel.from_arch(get_arch(name))) \
            == dataclasses.asdict(jocc.TimingModel.from_arch(jget_arch(name)))
    with pytest.raises(ValueError, match="fidelity"):
        tocc.simulate_traffic(get_arch(ARCHS[0]), [], fidelity="bogus")
