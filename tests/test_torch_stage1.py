"""Parity of the port's Stage I (`repro_torch.core.workload`,
`repro_torch.sim.{accelerator,engine,pss}`, `repro_torch.core.energy`) and
of its Stage-II entry points over a `SimResult` (`sweep`, `pareto_points`,
`alpha_sensitivity`, `policy_sensitivity`, the `trapti` CLI) with the
reference package on the CPU.

Stage I is host code copied from the reference: its traces must equal the
reference's bit for bit (segment durations compared as bit patterns, byte
counts and access statistics exactly), at the golden fixtures' size and at
the paper models' full width. Stage II runs the port's plain float64 path
against the reference's numpy path: rows and counts equal, energies within
rel 1e-12 (float64 sums taken in another order)."""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import golden_util
from golden_util import CASES, diff_payload

import repro.launch.trapti as jax_trapti
from repro.configs import get_arch as jax_arch
from repro.configs import reduced as jax_reduced
from repro.core.energy import assemble_energy as jax_energy
from repro.core.explorer import alpha_sensitivity as jax_alpha
from repro.core.explorer import pareto_points as jax_pareto
from repro.core.explorer import sweep as jax_sweep
from repro.core.gating import Policy as JaxPolicy
from repro.core.sensitivity import policy_sensitivity as jax_sensitivity
from repro.core.workload import build_decode_graph as jax_decode_graph
from repro.core.workload import build_graph as jax_graph
from repro.sim.accelerator import baseline_accelerator as jax_accel
from repro.sim.accelerator import multilevel_accelerator as jax_multilevel
from repro.sim.engine import find_min_sram as jax_find_min_sram
from repro.sim.engine import simulate as jax_simulate
from repro.sim.pss import simulate_decode as jax_simulate_decode

import repro_torch.launch.trapti as trapti
from repro_torch import configs as tconfigs
from repro_torch.core.energy import assemble_energy
from repro_torch.core.explorer import (alpha_sensitivity, min_capacity_mib,
                                       pareto_points, sweep)
from repro_torch.core.gating import Policy
from repro_torch.core.sensitivity import evaluate_drowsy, policy_sensitivity
from repro_torch.core.workload import build_decode_graph, build_graph
from repro_torch.sim.accelerator import (baseline_accelerator,
                                         multilevel_accelerator)
from repro_torch.sim.engine import Engine, find_min_sram, simulate
from repro_torch.sim.pss import simulate_decode

MIB = 2**20
REL = 1e-12
PAPER = ("dsr1d-qwen-1.5b", "gpt2-xl")
# the paper's decode horizon: context 2048, 1024 steps, batch 16, PSS, on
# the baseline accelerator's 128 MiB SRAM; segments and peak needed bytes
# of the reference's run
HORIZON = dict(start_ctx=2048, steps=1024, batch=16, fidelity="pss")
HORIZON_SHAPE = {"dsr1d-qwen-1.5b": (966_776, 13_930_496),
                 "gpt2-xl": (1_349_946, 79_897_200)}


def _bits(x):
    return np.asarray(x, np.float64).view(np.int64)


def _assert_same_sim(got, want):
    """Two Stage-I results equal: scalars and access statistics exactly,
    every memory's segments with durations bit for bit."""
    for key in ("total_time", "writebacks", "total_macs", "total_vector_ops",
                "dram_traffic_bytes", "graph_name", "accel_name"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.access.reads_bytes == want.access.reads_bytes
    assert got.access.writes_bytes == want.access.writes_bytes
    assert got.access.access_width == want.access.access_width
    assert sorted(got.traces) == sorted(want.traces)
    for m in want.traces:
        a = got.traces[m].segments(got.total_time)
        b = want.traces[m].segments(want.total_time)
        assert np.array_equal(_bits(a[0]), _bits(b[0])), m
        for x, y in zip(a[1:], b[1:]):
            assert np.array_equal(x, y), m
        assert got.traces[m].peak_needed() == want.traces[m].peak_needed()
        assert got.traces[m].peak_total() == want.traces[m].peak_total()


def _arch(name, layers=None):
    """The same config in both packages (reduced to `layers` when given)."""
    t, j = tconfigs.get_arch(name), jax_arch(name)
    if layers is not None:
        t, j = tconfigs.reduced(t, layers=layers), jax_reduced(j,
                                                               layers=layers)
    return t, j


# ---------------------------------------------------------------- configs
def test_registry_is_the_references():
    from repro import configs as jconfigs
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert tconfigs.PAPER_ARCHS == jconfigs.PAPER_ARCHS
    for name in jconfigs.list_archs():
        t, j = _arch(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for spelling in ("dsr1d_qwen_1_5b", "GPT2_XL", "qwen2-7b"):
        assert tconfigs.resolve_arch(spelling).name == \
            jconfigs.resolve_arch(spelling).name
    for name in ("mamba2-130m", "qwen2-7b"):
        for shape in jconfigs.SHAPES:
            assert tconfigs.shape_supported(
                tconfigs.get_arch(name), tconfigs.SHAPES[shape]) == \
                jconfigs.shape_supported(jax_arch(name),
                                         jconfigs.SHAPES[shape])


@pytest.mark.parametrize("name", tconfigs.list_archs())
def test_every_config_lowers_to_the_references_graph(name):
    """`build_graph` is family-aware: every registered config lowers, to
    the reference's ops and tensors."""
    t, j = _arch(name, layers=2)
    got, want = build_graph(t, M=64, subops=2), jax_graph(j, M=64, subops=2)
    assert got.name == want.name
    for mine, theirs in ((got.ops, want.ops), (got.tensors, want.tensors)):
        assert {k: dataclasses.astuple(v) for k, v in mine.items()} == \
            {k: dataclasses.astuple(v) for k, v in theirs.items()}
    assert got.total_macs() == want.total_macs()
    assert got.total_weight_bytes() == want.total_weight_bytes()


# ---------------------------------------------------------------- goldens
@pytest.fixture
def port_golden(monkeypatch):
    """`golden_util.case_payload` with the port's functions in place of the
    reference's."""
    for name, fn in (("get_arch", tconfigs.get_arch),
                     ("reduced", tconfigs.reduced),
                     ("build_graph", build_graph),
                     ("build_decode_graph", build_decode_graph),
                     ("baseline_accelerator", baseline_accelerator),
                     ("simulate", simulate)):
        monkeypatch.setattr(golden_util, name, fn)
    return golden_util.case_payload


@pytest.mark.parametrize("memoize", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_reproduces_stage1_golden(case, memoize, port_golden):
    """The frozen fixtures of `tests/golden/stage1_golden.json`, exactly;
    with layer memoization occupancy stays exact and timestamps agree to
    float-translation error, as the reference's own golden test holds."""
    want = golden_util.load_golden()[case]
    got = port_golden(case, memoize_layers=memoize)
    errs = diff_payload(got, want, time_rtol=1e-9 if memoize else 0.0)
    assert not errs, "\n".join(errs)


# ------------------------------------------------------- full-width Stage I
@pytest.mark.parametrize("name", PAPER)
def test_full_width_prefill_equals_reference(name):
    t, j = _arch(name)
    got = simulate(build_graph(t, M=2048, subops=4), baseline_accelerator(128))
    want = jax_simulate(jax_graph(j, M=2048, subops=4), jax_accel(128))
    _assert_same_sim(got, want)
    assert got.pe_utilization == want.pe_utilization


@pytest.mark.parametrize("name", PAPER)
def test_full_width_decode_horizon_equals_reference(name):
    """The paper's decode horizon through PSS at full width: about a
    million segments, bit for bit the reference's."""
    t, j = _arch(name)
    got = simulate_decode(t, baseline_accelerator(128), **HORIZON)
    want = jax_simulate_decode(j, jax_accel(128), **HORIZON)
    assert got.fidelity == want.fidelity == "pss"
    assert got.probes == want.probes
    assert np.array_equal(_bits(got.step_latency), _bits(want.step_latency))
    _assert_same_sim(got, want)
    n_segments, peak = HORIZON_SHAPE[name]
    assert len(got.traces["sram"].segments(got.total_time)[0]) == n_segments
    assert got.peak_needed("sram") == peak


# ----------------------------------------------- PSS against the exact DES
@pytest.mark.parametrize("arch,start,steps,subops", [
    ("gpt2-xl", 64, 24, 2), ("dsr1d-qwen-1.5b", 64, 24, 2),
    ("dsr1d-qwen-1.5b", 200, 17, 1)])
def test_pss_matches_exact_des(arch, start, steps, subops):
    """`tests/test_pss.py`'s FAST_GRID on the port's copy: probe steps are
    the exact DES stream bit for bit, interior steps keep the needed
    curve, the totals and the access counters; and each fidelity equals
    the reference's."""
    t, j = _arch(arch, layers=2)
    kw = dict(start_ctx=start, steps=steps, batch=4, subops=subops)
    ex = simulate_decode(t, baseline_accelerator(32), fidelity="exact", **kw)
    ps = simulate_decode(t, baseline_accelerator(32), fidelity="pss", **kw)
    assert ps.fidelity == "pss" and ex.fidelity == "exact"
    assert ex.total_macs == ps.total_macs
    assert ex.access.reads_bytes == ps.access.reads_bytes
    assert ex.access.writes_bytes == ps.access.writes_bytes
    assert abs(ex.total_time - ps.total_time) <= 5e-3 * ex.total_time
    for m in ex.traces:
        for i in range(ex.steps):
            te, dne, doe = ex.step_events(m, i)
            tp, dnp, dop = ps.step_events(m, i)
            if ex.step_ctx(i) in ps.probes:
                assert np.array_equal(_bits(te), _bits(tp)), (m, i)
            assert np.array_equal(dne, dnp) and np.array_equal(doe, dop)
        assert ex.traces[m].peak_needed() == ps.traces[m].peak_needed()
    for fidelity, got in (("exact", ex), ("pss", ps)):
        want = jax_simulate_decode(j, jax_accel(32), fidelity=fidelity, **kw)
        assert got.probes == want.probes
        _assert_same_sim(got, want)


@pytest.mark.parametrize("name", PAPER)
def test_memoized_des_occupancy_is_bit_exact(name):
    """`memoize_layers=True` replays layers with occupancy and access
    counters bit-exact against the plain DES, and equals the reference's
    memoized run bit for bit."""
    t, j = _arch(name)
    g = build_decode_graph(t, context_len=384, batch=4, subops=2)
    plain = simulate(g, baseline_accelerator(128))
    eng = Engine(g, baseline_accelerator(128), memoize_layers=True)
    memo = eng.run()
    assert memo.replayed_layers > 0, eng.memo_misses
    assert memo.access.reads_bytes == plain.access.reads_bytes
    assert memo.access.writes_bytes == plain.access.writes_bytes
    for m in plain.traces:
        assert memo.traces[m].ev_dneeded == plain.traces[m].ev_dneeded
        assert memo.traces[m].ev_dobsolete == plain.traces[m].ev_dobsolete
    want = jax_simulate(jax_decode_graph(j, context_len=384, batch=4,
                                         subops=2), jax_accel(128),
                        memoize_layers=True)
    assert memo.replayed_layers == want.replayed_layers
    _assert_same_sim(memo, want)


@pytest.mark.parametrize("name", PAPER)
def test_find_min_sram_equals_reference(name):
    t, j = _arch(name)
    got_mib, got = find_min_sram(build_graph(t, M=2048, subops=4),
                                 baseline_accelerator(128), lo_mib=16,
                                 hi_mib=256, step_mib=16)
    want_mib, want = jax_find_min_sram(jax_graph(j, M=2048, subops=4),
                                       jax_accel(128), lo_mib=16,
                                       hi_mib=256, step_mib=16)
    assert got_mib == want_mib
    _assert_same_sim(got, want)


@pytest.mark.parametrize("multilevel", [False, True])
def test_assemble_energy_equals_reference(multilevel):
    t, j = _arch("dsr1d-qwen-1.5b", layers=4)
    accel = multilevel_accelerator(8) if multilevel else \
        baseline_accelerator(32)
    jaccel = jax_multilevel(8) if multilevel else jax_accel(32)
    got = assemble_energy(simulate(build_graph(t, M=256, subops=2), accel),
                          accel).as_dict()
    want = jax_energy(jax_simulate(jax_graph(j, M=256, subops=2), jaccel),
                      jaccel).as_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= REL * abs(want[k]), k


# ------------------------------------------------- Stage II over a SimResult
@pytest.fixture(scope="module")
def decode_pair():
    """A reduced dsr1d decode horizon (PSS) from each package."""
    t, j = _arch("dsr1d-qwen-1.5b", layers=2)
    kw = dict(start_ctx=64, steps=32, batch=4, subops=2, fidelity="pss")
    return (simulate_decode(t, baseline_accelerator(32), **kw),
            jax_simulate_decode(j, jax_accel(32), **kw))


@pytest.fixture(scope="module")
def prefill_pair():
    t, j = _arch("gpt2-xl", layers=2)
    return (simulate(build_graph(t, M=256, subops=2), baseline_accelerator(8)),
            jax_simulate(jax_graph(j, M=256, subops=2), jax_accel(8)))


def _assert_same_rows(got, want):
    assert [(r.capacity_mib, r.banks, r.result.n_transitions)
            for r in got.rows] == [(r.capacity_mib, r.banks,
                                    r.result.n_transitions)
                                   for r in want.rows]
    assert got.rows
    for a, b in zip(got.rows, want.rows):
        assert abs(a.result.e_total / b.result.e_total - 1.0) <= REL
        assert a.result.area_mm2 == b.result.area_mm2
        assert abs(a.delta_e_pct - b.delta_e_pct) <= 1e-9


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("policy", ["conservative", "aggressive"])
@pytest.mark.parametrize("which", ["prefill", "decode"])
def test_sweep_over_sim_result_equals_reference(which, policy, prune,
                                                prefill_pair, decode_pair):
    """`sweep` takes a `SimResult` (needed occupancy of the SRAM) as the
    reference's `TraceSource` does; rows equal the reference's numpy path."""
    got_sim, want_sim = prefill_pair if which == "prefill" else decode_pair
    m = min_capacity_mib(got_sim.peak_needed("sram"))
    kw = dict(capacities_mib=[m, m + 16, m + 32], prune=prune)
    got = sweep(got_sim, device="cpu", policy=Policy.by_name(policy), **kw)
    want = jax_sweep(want_sim, backend="numpy",
                     policy=JaxPolicy.by_name(policy), **kw)
    _assert_same_rows(got, want)


def test_pareto_and_alpha_sensitivity_equal_reference(prefill_pair,
                                                      decode_pair):
    tables, jtables = [], []
    for got_sim, want_sim in (prefill_pair, decode_pair):
        m = min_capacity_mib(got_sim.peak_needed("sram"))
        tables.append(sweep(got_sim, capacities_mib=[m, m + 16],
                            device="cpu"))
        jtables.append(jax_sweep(want_sim, capacities_mib=[m, m + 16],
                                 backend="numpy"))
    got, want = pareto_points(tables), jax_pareto(jtables)
    assert [p[2:] for p in got] == [p[2:] for p in want]
    np.testing.assert_allclose([p[:2] for p in got], [p[:2] for p in want],
                               rtol=REL, atol=0)
    got_sim, want_sim = decode_pair
    m = min_capacity_mib(got_sim.peak_needed("sram"))
    got = alpha_sensitivity(got_sim, capacity_mib=m, banks=8, device="cpu")
    want = jax_alpha(want_sim, capacity_mib=m, banks=8, backend="numpy")
    assert list(got) == list(want)
    for a in want:
        assert got[a].n_transitions == want[a].n_transitions
        assert abs(got[a].e_total / want[a].e_total - 1.0) <= REL


def test_policy_sensitivity_and_drowsy_equal_reference(decode_pair):
    got_sim, want_sim = decode_pair
    dur, occ = got_sim.traces["sram"].occupancy_series(got_sim.total_time,
                                                       use="needed")
    kw = dict(capacity=16 * MIB, banks=8,
              n_reads=got_sim.access.n_reads("sram"),
              n_writes=got_sim.access.n_writes("sram"))
    got = policy_sensitivity(dur, occ, device="cpu", **kw)
    want = jax_sensitivity(dur, occ, backend="numpy", **kw)
    assert {k: list(v) for k, v in got.items()} == \
        {k: list(v) for k, v in want.items()}
    for k in want:
        for p in want[k]:
            assert abs(got[k][p] / want[k][p] - 1.0) <= REL, (k, p)
    from repro.core.sensitivity import evaluate_drowsy as jax_drowsy
    a = evaluate_drowsy(dur, occ, capacity=16 * MIB, banks=8)
    b = jax_drowsy(dur, occ, capacity=16 * MIB, banks=8)
    assert dataclasses.astuple(a) == dataclasses.astuple(b)


# -------------------------------------------------------------------- CLI
def _cli(monkeypatch, tmp_path, module, arch_fn, argv, tag):
    out = tmp_path / f"{tag}.json"
    monkeypatch.setattr(module, "get_arch",
                        lambda name: arch_fn(name, layers=2))
    monkeypatch.setattr(sys, "argv", ["trapti", *argv, "--json", str(out)])
    module.main()
    return json.loads(out.read_text())


def _close(got, want, path=""):
    """Payloads equal: Stage-I numbers exactly, Stage-II energies (the
    delta percentages, the sensitivity grid) within rel 1e-12."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, float) and ("delta" in path or "sensitivity"
                                      in path):
        assert abs(got - want) <= REL * max(abs(want), 100.0), path
    else:
        assert got == want, path


@pytest.mark.parametrize("argv", [
    ["--seq", "256"],
    ["--seq", "256", "--prune", "--policy", "drowsy", "--sensitivity"],
    ["--seq", "128", "--multilevel", "--scheduler", "mempeak"],
    ["--seq", "64", "--fidelity", "pss", "--decode-steps", "24",
     "--decode-batch", "4"],
    ["--seq", "64", "--fidelity", "auto"],
], ids=["prefill", "prefill-drowsy-sensitivity", "multilevel-mempeak",
        "pss-decode", "auto-default-steps"])
def test_cli_json_equals_reference(argv, monkeypatch, tmp_path, capsys):
    """`python -m repro_torch.launch.trapti --device cpu --json` against the
    reference CLI's `--backend numpy --json`, on the reduced config."""
    def reduced_port(name, layers):
        return tconfigs.reduced(tconfigs.get_arch(name), layers=layers)

    def reduced_jax(name, layers):
        return jax_reduced(jax_arch(name), layers=layers)

    got = _cli(monkeypatch, tmp_path, trapti, reduced_port,
               [*argv, "--device", "cpu"], "port")
    port_out = capsys.readouterr().out
    want = _cli(monkeypatch, tmp_path, jax_trapti, reduced_jax,
                [*argv, "--backend", "numpy"], "ref")
    ref_out = capsys.readouterr().out
    _close(got, want)
    assert got["memories"]
    assert port_out.splitlines()[:2] == ref_out.splitlines()[:2]


def test_cli_refuses_a_missing_card(monkeypatch):
    """The CLI's default device is the card: without one it raises, and
    never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(sys, "argv", ["trapti", "--seq", "64"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trapti.main()


# ------------------------------------------------------------------- card
@pytest.mark.gpu
def test_bank_kernels_on_a_stage1_decode_horizon_on_card():
    """Kernels 3 and 4 against their plain versions on the paper's decode
    horizon (dsr1d-qwen-1.5b at full width, about a million segments) and
    the sweep's (C, B) grid: counts equal, seconds within rel 1e-12; and
    the pruned sweep on the card equals the one on the CPU (run on a
    machine with a card: `python -m pytest -m gpu tests`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.cacti import characterize
    from repro_torch.core.candidates import Candidate
    from repro_torch.kernels.bank_energy import (bank_activity_stats,
                                                 bank_energy_ref,
                                                 exact_bank_stats,
                                                 exact_bank_stats_ref)
    cfg = tconfigs.get_arch("dsr1d-qwen-1.5b")
    sim = simulate_decode(cfg, baseline_accelerator(128), **HORIZON)
    dur, occ = sim.traces["sram"].occupancy_series(sim.total_time,
                                                   use="needed")
    m = min_capacity_mib(sim.peak_needed("sram"))
    cands = [Candidate(c * MIB, b, 0.9, "gate", 5.0)
             for c in (m, m + 16, m + 32) for b in (1, 2, 4, 8, 16, 32)]
    th = [c.min_gate_multiple * characterize(c.capacity,
                                             c.banks).break_even_s
          for c in cands]
    d, o, u, nb, t = (torch.as_tensor(np.asarray(x, np.float64),
                                      device="cuda")
                      for x in (dur, occ, [c.usable_bytes for c in cands],
                                [float(c.banks) for c in cands], th))
    got, want = exact_bank_stats(d, o, u, nb, t), exact_bank_stats_ref(
        d, o, u, nb, t)
    assert torch.equal(got[:, [1, 3]], want[:, [1, 3]])
    sec = [0, 2, 4]
    assert float(((got[:, sec] - want[:, sec]).abs()
                  / want[:, sec].abs().clamp_min(1e-300)).max()) <= REL
    got, want = bank_activity_stats(d, o, u, nb), bank_energy_ref(d, o, u,
                                                                  nb)
    assert torch.equal(got[:, 1], want[:, 1])
    assert float(((got[:, 0] - want[:, 0]).abs()
                  / want[:, 0].abs()).max()) <= REL
    kw = dict(capacities_mib=[m, m + 16, m + 32], prune=True)
    _assert_same_rows(sweep(sim, device="cuda", **kw),
                      sweep(sim, device="cpu", **kw))
