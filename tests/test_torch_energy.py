"""Parity of the port's streaming bank-energy meter and its Perfetto export
with the JAX package's (`repro.obs.energy`, `repro.obs.perfetto`,
`repro.obs.slo`) on the CPU.

The meter's copy reproduces `tests/golden/energy_golden.json` exactly (the
track schema included); its finalized energy equals the port's
`core.gating.evaluate` bit for bit on seeded streams across the four
policies, as the reference's equals its own; and the port's meter, fed the
same stream as the reference's, gives the same attribution, wake counts,
bank intervals and Perfetto events. The copied modules' code is the
reference's: the same syntax tree once names and module docstrings are
normalised."""
import ast
import json
from pathlib import Path

import numpy as np
import pytest

import golden_util
import repro.obs.energy as jenergy
import repro.obs.perfetto as jperfetto
import repro.obs.slo as jslo
import repro.obs.telemetry as jtel
import repro.traffic.occupancy as joccupancy
from repro.core.gating import Policy as JPolicy
import repro_torch.obs.energy as tenergy
import repro_torch.obs.perfetto as tperfetto
import repro_torch.obs.slo as tslo
import repro_torch.obs.telemetry as ttel
import repro_torch.traffic.occupancy as toccupancy
from repro_torch.configs import get_arch
from repro_torch.core.gating import Policy, bank_timeline, evaluate
from repro_torch.sim.trace import OccupancyTrace
from repro_torch.traffic import (LengthModel, generate_workload,
                                 simulate_prefix_traffic)

MIB = 2**20
POLICIES = ("none", "aggressive", "conservative", "drowsy")


# ------------------------------------------------------------ the copies
def _tree(mod) -> str:
    t = ast.parse(Path(mod.__file__).read_text())
    t.body = t.body[1:] if isinstance(t.body[0], ast.Expr) else t.body
    return ast.dump(t).replace("repro_torch", "repro")


@pytest.mark.parametrize("port,ref", [
    (tslo, jslo), (tperfetto, jperfetto), (tenergy, jenergy),
    (toccupancy, joccupancy)], ids=["slo", "perfetto", "energy", "occupancy"])
def test_copied_module_equals_original(port, ref):
    assert _tree(port) == _tree(ref)


# ------------------------------------------------------------ the golden
def _energy_case_run(name):
    """`golden_util._energy_case_run` through the port's modules."""
    case = golden_util.ENERGY_CASES[name]
    spec = golden_util.PREFIX_CASES[case["base"]]
    cfg = get_arch(spec["arch"])
    lengths = LengthModel(max_len=spec["max_len"])
    reqs = generate_workload(spec["workload"], spec["rate"],
                             spec["horizon_s"], seed=spec["seed"],
                             lengths=lengths, prefix_len=spec["prefix_len"],
                             sharing=spec["sharing"], fanout=spec["sharing"])
    if "off_multiple" in case:
        c_mib, banks, alpha, pname = case["meter"].split(",")
        assert pname == "drowsy"
        pol = Policy.drowsy(float(alpha),
                            off_multiple=float(case["off_multiple"]))
        meter = tenergy.BankEnergyMeter(int(float(c_mib)) << 20, int(banks),
                                        policy=pol)
    else:
        meter = tenergy.BankEnergyMeter.from_spec(case["meter"])
    sim = simulate_prefix_traffic(cfg, reqs, num_slots=spec["num_slots"],
                                  page_size=spec["page_size"],
                                  max_len=spec["max_len"],
                                  seed=spec["seed"], meter=meter)
    return meter, float(sim.total_time)


def _energy_payload(name):
    """`golden_util.energy_case_payload` through the port's modules."""
    P = tperfetto
    meter, end = _energy_case_run(name)
    evs = P.bank_state_events(meter, end_time=end)
    lanes = sorted(e["args"]["name"] for e in evs
                   if e["ph"] == "M" and e["name"] == "thread_name")
    spans = [e for e in evs if e["ph"] == "X"]
    counters = sorted({e["name"] for e in evs if e["ph"] == "C"})
    state_counts: dict = {}
    for e in spans:
        state_counts[e["name"]] = state_counts.get(e["name"], 0) + 1
    res = meter.finalize(end)
    return meter, end, evs, {
        "total_time": end,
        "n_meter_events": meter.n_events,
        "track_schema": {
            "pid": P.BANKS_PID,
            "process": next(e["args"]["name"] for e in evs
                            if e["ph"] == "M"
                            and e["name"] == "process_name"),
            "lanes": lanes,
            "counters": counters,
            "span_keys": sorted(spans[0].keys()),
            "span_arg_keys": sorted(spans[0]["args"].keys()),
            "active_counter": P.ACTIVE_COUNTER,
            "energy_counter": P.ENERGY_COUNTER,
        },
        "n_span_events": len(spans),
        "state_counts": dict(sorted(state_counts.items())),
        "e_leak_j": res.e_leak,
        "e_sw_j": res.e_sw,
        "n_transitions": res.n_transitions,
        "live_e_j": meter.energy_j(end),
        "energy_counter_total_j": P.energy_counter_total(evs),
        "wakes": dict(sorted(meter.wake_counts(end).items())),
        "stall_s": meter.stall_s(end),
    }


@pytest.mark.parametrize("case", sorted(golden_util.ENERGY_CASES))
def test_meter_reproduces_energy_golden(case):
    """Every field of the frozen fixture, floats bit for bit, and the
    exported energy track survives a JSON round trip losslessly."""
    want = golden_util.load_energy_golden()[case]
    meter, end, evs, got = _energy_payload(case)
    for key, val in got.items():
        assert val == want[key], key
    evs = json.loads(json.dumps(evs))
    assert tperfetto.energy_counter_total(evs) == want["live_e_j"]
    t0s, durs, act = meter.activity_series(end)
    end_us = float((t0s[-1] + durs[-1]) * 1e6)
    got_i = tperfetto.counter_integral(evs, tperfetto.ACTIVE_COUNTER, end_us,
                                       series="active")
    assert np.isclose(got_i / 1e6, float((act * durs).sum()), rtol=1e-9)


# ------------------------------------------------ streaming vs offline
def _random_events(rng, n, capacity):
    """The reference tests' tagged stream: duplicate timestamps, growth and
    frees, occupancy within [0, capacity]."""
    ts = np.sort(rng.uniform(0.0, 2.0, n))
    for i in range(1, n, 5):
        ts[i] = ts[i - 1]
    evs, occ = [], 0
    for i in range(n):
        if occ and rng.random() < 0.35:
            dn = -int(rng.integers(1, occ + 1))
        else:
            dn = int(rng.integers(0, max((capacity - occ) // 3, 2)))
        do = int(rng.integers(0, 4096))
        occ += dn
        evs.append((float(ts[i]), dn, do, f"r{i % 4}", f"tenant{i % 2}",
                    ("admission", "decode_growth", "cow")[i % 3]))
    return evs


def _feed(meter, evs, order=None):
    for i in (range(len(evs)) if order is None else order):
        t, dn, do, rid, ten, cause = evs[i]
        meter.record(t, dn, do, rid=rid, tenant=ten, cause=cause)


def _view(meter, end):
    """Everything a meter reports, for exact comparison."""
    res = meter.finalize(end)
    rep = meter.report(end, n_reads=3, n_writes=2)
    return (res.e_leak, res.e_sw, res.e_total, res.n_transitions,
            res.gated_bank_seconds, res.drowsy_bank_seconds,
            meter.energy_j(end), meter.request_energy_j(end),
            meter.tenant_energy_j(end), meter.floor_j(end),
            meter.wake_counts(end), meter.stall_s(end),
            [a.tolist() for a in meter.activity_series(end)],
            [a.tolist() for a in meter.energy_series(end)],
            meter.bank_intervals(end), rep.format(),
            meter.format_dashboard(end))


@pytest.mark.parametrize("policy", POLICIES)
def test_streaming_bit_identical_to_gating_evaluate(policy):
    """The port's meter equals the port's `gating.evaluate` bit for bit on
    seeded streams (out-of-order delivery included), its activity equals
    `bank_timeline`'s, and every view equals the reference meter's on the
    same stream."""
    rng = np.random.default_rng(POLICIES.index(policy) + 10)
    for trial in range(8):
        C = int(rng.choice([MIB, 4 * MIB, 8 * MIB]))
        B = int(rng.choice([2, 4, 8, 16]))
        evs = _random_events(rng, int(rng.integers(3, 60)), C)
        order = rng.permutation(len(evs)) if trial % 2 else None
        m = tenergy.BankEnergyMeter(C, B, policy=policy)
        jm = jenergy.BankEnergyMeter(C, B, policy=policy)
        _feed(m, evs, order)
        _feed(jm, evs, order)
        end = max(e[0] for e in evs) + float(rng.uniform(0.0, 0.5))
        tr = OccupancyTrace("kv", C)
        for t, dn, do, *_ in evs:
            tr.event(t, dn, do)
        dur, occ = tr.occupancy_series(end, use="needed")
        pol = Policy.by_name(policy)
        ref = evaluate(dur, occ, capacity=C, banks=B, policy=pol,
                       n_reads=0, n_writes=0)
        got = m.finalize(end)
        assert (got.e_leak, got.e_sw, got.e_total, got.n_transitions,
                got.gated_bank_seconds, got.drowsy_bank_seconds) == \
            (ref.e_leak, ref.e_sw, ref.e_total, ref.n_transitions,
             ref.gated_bank_seconds, ref.drowsy_bank_seconds)
        if pol.gate:
            tl = bank_timeline(dur, occ, capacity=C, banks=B,
                               alpha=pol.alpha)
            assert np.array_equal(m.activity_series(end)[2],
                                  tl["active_banks"])
        assert _view(m, end) == _view(jm, end)


def test_meter_spec_prewake_and_counters_match_reference():
    got = []
    for E, T, pol in ((tenergy, ttel, Policy), (jenergy, jtel, JPolicy)):
        tel = T.Telemetry(enabled=True)
        m = E.BankEnergyMeter.from_spec("8,4,0.75,aggressive", telemetry=tel)
        _feed(m, _random_events(np.random.default_rng(7), 40, 8 * MIB))
        m.note_prewake(3)
        m.finalize()
        d = E.BankEnergyMeter(2 * MIB, 4, policy=pol.drowsy(0.9), alpha=0.5)
        got.append((m.wake_counts(), tel.snapshot(), m.policy, d.policy,
                    m.capacity, m.banks))
    assert got[0][:2] == got[1][:2]
    assert [vars(p) for p in got[0][2:4]] == [vars(p) for p in got[1][2:4]]
    with pytest.raises(ValueError):
        tenergy.BankEnergyMeter.from_spec("8")
    with pytest.raises(ValueError):
        tenergy.BankEnergyMeter(MIB, 2, use="bogus")


# ------------------------------------------------------------ the export
def _span_registry(T):
    tel = T.Telemetry(enabled=True)
    tel.add_span("request", 0.0, 0.5, rid=0, tokens=4)
    tel.add_span("prefill", 0.0, 0.1, slot=1, rid=0, tokens=9)
    tel.add_span("decode_chunk", 0.1, 0.3, slots=2)
    tel.add_span("cow", 0.2, 0.2, slot=0, page=7)
    tel.add_span("campaign.simulate", 0.05, 0.06)
    return tel


def test_chrome_trace_events_match_reference(tmp_path):
    """`chrome_trace_events` / `bank_state_events` / `export_chrome_trace`
    event for event: spans, occupancy counter tracks and a meter's bank
    lanes, from the same inputs through each package."""
    evs = _random_events(np.random.default_rng(5), 50, 4 * MIB)
    outs = []
    for E, P, T in ((tenergy, tperfetto, ttel),
                    (jenergy, jperfetto, jtel)):
        m = E.BankEnergyMeter(4 * MIB, 8, policy="drowsy")
        _feed(m, evs)
        tr = OccupancyTrace("kv", 4 * MIB)
        for t, dn, do, *_ in evs:
            tr.event(t, max(dn, 0), 0)
        tel = _span_registry(T)
        end = 2.5
        path = tmp_path / f"{P.__name__}.json"
        obj = P.export_chrome_trace(str(path), tel, traces=[tr],
                                    end_time=end, meter=m,
                                    other_data={"k": 1})
        outs.append((P.chrome_trace_events(tel, [tr], end_time=end,
                                           meter=m),
                     P.bank_state_events(m, end_time=end),
                     json.loads(path.read_text()) == json.loads(
                         json.dumps(obj)),
                     P.counter_integral(obj["traceEvents"],
                                        "kv occupancy [B]", end * 1e6),
                     P.energy_counter_total(obj["traceEvents"])))
    assert outs[0] == outs[1]
    assert outs[0][2]


def test_slo_copy_behaves_as_original():
    got = []
    for S, T in ((tslo, ttel), (jslo, jtel)):
        rng = np.random.default_rng(2)
        tel = T.Telemetry(enabled=True)
        tr = S.SLOTracker(tel, "serve.x")
        for rid in range(12):
            tl = S.RequestTimeline(rid=rid, submit_t=float(rid))
            tl.admit_t = rid + 0.1
            tl.first_token_t = rid + float(rng.uniform(0.1, 0.5))
            tl.token_ts = list(tl.first_token_t
                               + np.cumsum(rng.uniform(0, 0.01, rid % 4)))
            tl.token_ts.insert(0, tl.first_token_t)
            if rid == 3:
                tl.reset_admission()
                tl.first_token_t = 3.5
                tl.token_ts = [3.5]
            tl.finish_t = tl.token_ts[-1] + 0.01
            tr.observe(tl)
        s = tr.summary()
        e = S.attach_energy_percentiles(
            S.percentile_summary([0.1, 0.3, 0.2], tr.tbt, [1.0, 2.0]),
            {r: 1e-3 * (r + 1) for r in range(5)}, {r: r for r in range(5)})
        got.append((vars(s), vars(e), s.format(), e.format(),
                    tel.snapshot()))
    assert got[0] == got[1]
