"""Parity of the port's Stage II (`repro_torch.core`) with the JAX
reference's float64 numpy path on the CPU: the batched candidate engine and
the (C, B) sweep must give the same rows, counts equal and energies within
rel 1e-12 (float64 sums taken in another order)."""
import numpy as np
import pytest

from repro.core.candidates import evaluate_candidates as jax_evaluate
from repro.core.candidates import make_grid as jax_grid
from repro.core.explorer import sweep as jax_sweep
from repro.core.gating import Policy as JaxPolicy
from repro.sim.trace import AccessStats as JaxAccess
from repro.sim.trace import OccupancyTrace as JaxTrace
from repro.sim.trace import TraceBundle as JaxBundle
from repro_torch.core.candidates import evaluate_candidates, make_grid
from repro_torch.core.explorer import min_capacity_mib, sweep
from repro_torch.core.gating import Policy, evaluate
from repro_torch.sim.trace import AccessStats, OccupancyTrace, TraceBundle

MIB = 2**20
REL = 1e-12


def _bundles(seed, n_events=300, page=458_752):
    """The same page-granular serving-like trace in both packages: random
    alloc/free deltas of whole pages, on a logical clock with microsecond
    prefill steps and millisecond decode steps."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(np.where(rng.random(n_events) < 0.3, 5e-5, 1e-3))
    deltas = rng.integers(-3, 5, n_events)
    level = 0
    for i, dlt in enumerate(deltas):       # never free more than is held
        deltas[i] = max(int(dlt), -level)
        level += deltas[i]
    deltas = np.r_[deltas, -level]
    t = np.r_[t, t[-1] + 1e-3]
    out = []
    for Trace, Access, Bundle in ((JaxTrace, JaxAccess, JaxBundle),
                                  (OccupancyTrace, AccessStats, TraceBundle)):
        tr = Trace("kv", 300 * page)
        for ti, dv in zip(t, deltas):
            tr.event(float(ti), int(dv) * page, 0)
        acc = Access()
        acc.add_read("kv", 123_456_789)
        acc.add_write("kv", 9_876_543)
        out.append(Bundle("serve", float(t[-1]) + 2e-3, {"kv": tr}, acc))
    return out


def _rows(table):
    return [(r.capacity_mib, r.banks, r.result.n_transitions)
            for r in table.rows]


def _assert_same_tables(got, want):
    assert _rows(got) == _rows(want)
    assert len(got.rows) > 0
    for a, b in zip(got.rows, want.rows):
        assert abs(a.result.e_total / b.result.e_total - 1.0) <= REL
        assert abs(a.result.e_leak - b.result.e_leak) <= REL * abs(
            b.result.e_leak)
        assert a.result.area_mm2 == b.result.area_mm2


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("policy", ["conservative", "aggressive"])
def test_sweep_matches_jax_numpy(seed, prune, policy):
    jb, tb = _bundles(seed)
    m = min_capacity_mib(tb.traces["kv"].peak_needed())
    kw = dict(mem_name="kv", capacities_mib=[m, m + 32, m + 64],
              banks=[1, 2, 4, 8, 16], prune=prune)
    want = jax_sweep(jb, backend="numpy", policy=JaxPolicy.by_name(policy),
                     **kw)
    got = sweep(tb, device="cpu", policy=Policy.by_name(policy), **kw)
    _assert_same_tables(got, want)


def test_sweep_below_peak_is_empty():
    _, tb = _bundles(0)
    assert sweep(tb, mem_name="kv", capacities_mib=[0], device="cpu").rows \
        == []


@pytest.mark.parametrize("policies", [("none", "gate", "drowsy")])
def test_evaluate_candidates_matches_jax_numpy(policies):
    jb, tb = _bundles(5)
    dur, occ = tb.traces["kv"].occupancy_series(tb.total_time)
    caps = [64 * MIB, 128 * MIB]
    kw = dict(n_reads=10_000, n_writes=2_000)
    want = jax_evaluate(dur, occ, jax_grid(caps, [1, 4, 16], (0.9, 1.0),
                                           policies), backend="numpy", **kw)
    got = evaluate_candidates(dur, occ, make_grid(caps, [1, 4, 16],
                                                  (0.9, 1.0), policies),
                              device="cpu", **kw)
    np.testing.assert_array_equal(got.n_off, want.n_off)
    np.testing.assert_array_equal(got.n_drowsy, want.n_drowsy)
    np.testing.assert_allclose(got.e_total, want.e_total, rtol=REL, atol=0)
    np.testing.assert_allclose(got.gated_bank_seconds,
                               want.gated_bank_seconds, rtol=REL, atol=0)


def test_batched_gate_matches_the_scalar_reference():
    _, tb = _bundles(7)
    dur, occ = tb.traces["kv"].occupancy_series(tb.total_time)
    pol = Policy.conservative()
    res = evaluate_candidates(dur, occ, make_grid([64 * MIB], [2, 8], (0.9,),
                                                  ("gate",), 5.0),
                              n_reads=5, n_writes=7, device="cpu")
    for i, b in enumerate([2, 8]):
        ref = evaluate(dur, occ, capacity=64 * MIB, banks=b, policy=pol,
                       n_reads=5, n_writes=7)
        got = res.gating_result(i)
        assert got.n_transitions == ref.n_transitions
        assert abs(got.e_total / ref.e_total - 1.0) <= REL


@pytest.mark.parametrize("policy", ["conservative", "aggressive"])
def test_pruned_sweep_scans_the_trace_once(monkeypatch, policy):
    """A pruned sweep computes the trace's running time once and hands it
    to both exact calls (the incumbent's and the survivors'); its rows and
    energies equal those of exact calls that compute their own."""
    import repro_torch.kernels.bank_energy as be
    scan, exact = be.running_time, be.exact_bank_stats
    scans, cums = [], []

    def counted_scan(d):
        scans.append(len(d))
        return scan(d)

    def given_cum(*args, cum=None):
        cums.append(cum)
        return exact(*args, cum=cum)

    _, tb = _bundles(3)
    m = min_capacity_mib(tb.traces["kv"].peak_needed())
    kw = dict(mem_name="kv", capacities_mib=[m, m + 32, m + 64],
              banks=[1, 2, 4, 8, 16], prune=True, device="cpu",
              policy=Policy.by_name(policy))
    monkeypatch.setattr(be, "running_time", counted_scan)
    monkeypatch.setattr(be, "exact_bank_stats", given_cum)
    shared = sweep(tb, **kw)
    assert len(scans) == 1 and len(cums) == 2
    assert cums[0] is not None and cums[1] is cums[0]
    monkeypatch.setattr(be, "exact_bank_stats",
                        lambda *args, cum=None: exact(*args))
    own = sweep(tb, **kw)
    assert _rows(shared) == _rows(own) and len(own.rows) > 0
    assert [r.result.e_total for r in shared.rows] == \
        [r.result.e_total for r in own.rows]
