"""Parity of the port's online power-gating controller and traffic campaign
(`traffic/controller`, `traffic/campaign`, `launch/traffic.py`) with the
JAX package's on the CPU.

The online legs (`simulate_online`, `simulate_online_forecast`) are host
code and must be equal. The offline legs go through the port's
`evaluate_candidates` (its plain float64 bank kernels on the CPU) and the
pruning bound through `lower_bound_energies`; their energies must agree
with the reference's within rel 1e-12 and everything else exactly. The
CLI's `--json` payload is held to the reference CLI's at the smoke sizes;
`SweepTable.by_capacity` to the reference's."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.traffic.campaign as jcamp
import repro.traffic.controller as jctl
import repro.traffic.generators as jgen
import repro.traffic.occupancy as jocc
from repro.configs import get_arch as jget_arch
from repro.core.explorer import sweep as jsweep
import repro_torch.traffic.campaign as tcamp
import repro_torch.traffic.controller as tctl
import repro_torch.traffic.generators as tgen
import repro_torch.traffic.occupancy as tocc
from repro_torch.configs import get_arch
from repro_torch.core.explorer import min_capacity_mib
from repro_torch.core.explorer import sweep as tsweep
from test_torch_traffic import plain

MIB = 2**20
RTOL = 1e-12
ROOT = Path(__file__).resolve().parents[1]


def close(a, b, path="", rtol=RTOL):
    """Structural equality of two plain values: floats within `rtol`
    relative, everything else exactly."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            close(a[k], b[k], f"{path}.{k}", rtol)
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            close(x, y, f"{path}[{i}]", rtol)
    elif isinstance(a, float) and rtol and a != b:
        assert abs(a - b) <= rtol * max(abs(a), abs(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


def offline_close(got, want):
    """A `ControllerComparison` (plain): the online and forecast legs
    exactly, the two offline legs within rel 1e-12."""
    for leg in ("online", "forecast"):
        assert got[leg] == want[leg], leg
    for leg in ("oracle", "none"):
        close(got[leg], want[leg], leg)


@pytest.fixture(scope="module")
def traces():
    """The occupancy series of a seeded poisson serve of each paper model,
    from each package's simulator (equal, `test_torch_traffic.py`)."""
    out = {}
    for name in ("dsr1d-qwen-1.5b", "gpt2-xl"):
        pair = []
        for occ, G, ga in ((tocc, tgen, get_arch), (jocc, jgen, jget_arch)):
            reqs = G.generate("poisson", 4.0, 10.0, seed=0,
                              lengths=G.LengthModel(max_len=1024))
            sim = occ.simulate_traffic(ga(name), reqs, num_slots=8,
                                       max_len=1024)
            dur, o = sim.trace.occupancy_series(sim.total_time, use="needed")
            pair.append((dur, o, sim.bundle.access.n_reads("kv"),
                         sim.bundle.access.n_writes("kv"), sim))
        out[name] = pair
    return out


@pytest.mark.parametrize("arch", ["dsr1d-qwen-1.5b", "gpt2-xl"])
@pytest.mark.parametrize("banks", [2, 8, 32])
def test_online_legs_equal_reference(traces, arch, banks):
    (td, to, nr, nw, _), (jd, jo, *_rest) = traces[arch]
    assert np.array_equal(td, jd) and np.array_equal(to, jo)
    cap = 2 * int(np.max(to)) + MIB
    for h in (1.0, 2.0):
        got = tctl.simulate_online(
            td, to, capacity=cap, banks=banks, n_reads=nr, n_writes=nw,
            cfg=tctl.ControllerConfig(hysteresis_multiple=h))
        want = jctl.simulate_online(
            jd, jo, capacity=cap, banks=banks, n_reads=nr, n_writes=nw,
            cfg=jctl.ControllerConfig(hysteresis_multiple=h))
        assert plain(got) == plain(want)
    for w, lead in ((2.0, None), (0.5, 0.01)):
        got = tctl.simulate_online_forecast(
            td, to, capacity=cap, banks=banks, n_reads=nr, n_writes=nw,
            fcfg=tctl.ForecastConfig(window_s=w, lead_s=lead))
        want = jctl.simulate_online_forecast(
            jd, jo, capacity=cap, banks=banks, n_reads=nr, n_writes=nw,
            fcfg=jctl.ForecastConfig(window_s=w, lead_s=lead))
        assert plain(got) == plain(want)
    assert got.pre_wakes >= 0


def test_compare_and_compare_grid_match_reference(traces):
    (td, to, nr, nw, _), (jd, jo, *_r) = traces["dsr1d-qwen-1.5b"]
    m = min_capacity_mib(int(np.max(to)))
    caps = [m, m + 16]
    points = [(c * MIB, b) for c in caps for b in (1, 4, 16)]
    kw = dict(n_reads=nr, n_writes=nw)
    got = tctl.compare(td, to, capacity=points[-1][0], banks=8, device="cpu",
                       fcfg=tctl.ForecastConfig(), **kw)
    want = jctl.compare(jd, jo, capacity=points[-1][0], banks=8,
                        fcfg=jctl.ForecastConfig(), **kw)
    offline_close(plain(got), plain(want))
    assert got.format() == want.format()
    got = tctl.compare_grid(td, to, points=points, device="cpu",
                            fcfg=tctl.ForecastConfig(), **kw)
    want = jctl.compare_grid(jd, jo, points=points,
                             fcfg=jctl.ForecastConfig(), **kw)
    assert list(got) == list(want) == points
    for p in points:
        offline_close(plain(got[p]), plain(want[p]))
    got = tcamp.fast_candidate_energies(
        td, to, capacities_mib=caps, banks=[1, 4, 16], alpha=0.9,
        device="cpu", **kw)
    want = jcamp.fast_candidate_energies(
        jd, jo, capacities_mib=caps, banks=[1, 4, 16], alpha=0.9, **kw)
    close(got.tolist(), np.asarray(want).tolist())


SCENARIOS = {
    "plain-metered": (dict(arch="dsr1d-qwen-1.5b"),
                      dict(meter_spec="32,8,0.9,conservative",
                           forecast=True)),
    "chat": (dict(arch="gpt2-xl", workload="chat_sysprompt",
                  prefix_len=128, sharing=4), dict()),
    "spec": (dict(arch="dsr1d-qwen-1.5b", speculate_k=4), dict()),
}


def _run_scenario(camp, ctl, scn_kw, run_kw, prune, **dev):
    run_kw = dict(run_kw)
    fcfg = ctl.ForecastConfig() if run_kw.pop("forecast", False) else None
    scn = camp.Scenario(horizon_s=5.0, num_slots=4, max_len=512, seed=3,
                        **scn_kw)
    sim, rows, fast = camp.run_scenario(
        scn, capacities_mib=None, banks=(1, 4, 8), ctrl=ctl.ControllerConfig(),
        fcfg=fcfg, prune=prune, **run_kw, **dev)
    return plain(rows), fast.tolist()


@pytest.mark.parametrize("prune", [False, True], ids=["full", "pruned"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_run_scenario_matches_reference(name, prune):
    """Rows equal (the offline legs' energies within rel 1e-12), the
    meter's report exactly, and pruning keeps the same points."""
    scn_kw, run_kw = SCENARIOS[name]
    got, gfast = _run_scenario(tcamp, tctl, scn_kw, run_kw, prune,
                               device="cpu")
    want, wfast = _run_scenario(jcamp, jctl, scn_kw, run_kw, prune)
    assert [(r["capacity_mib"], r["banks"]) for r in got] == \
        [(r["capacity_mib"], r["banks"]) for r in want]
    assert len(got) > 0
    for g, w in zip(got, want):
        gc, wc = g.pop("comparison"), w.pop("comparison")
        offline_close(gc, wc)
        assert g == w
    close(gfast, wfast)
    if run_kw.get("meter_spec"):
        assert got[0]["energy"]["request_j"]


def test_run_campaign_shares_streams_and_matches_reference():
    kw = dict(rates=(3.0,), horizon_s=4.0, num_slots=4, max_len=512,
              banks=(1, 8), prune=True)
    got = tcamp.run_campaign(["gpt2-xl", "dsr1d-qwen-1.5b"], device="cpu",
                             **kw)
    want = jcamp.run_campaign(["gpt2-xl", "dsr1d-qwen-1.5b"], **kw)
    assert sorted(got.sims) == sorted(want.sims)
    assert len(got.rows) == len(want.rows) > 0
    for g, w in zip(plain(got.rows), plain(want.rows)):
        offline_close(g.pop("comparison"), w.pop("comparison"))
        assert g == w
    assert got.format() == want.format()
    assert [(r.scenario.arch, r.capacity_mib, r.banks)
            for r in got.best_per_scenario()] == \
        [(r.scenario.arch, r.capacity_mib, r.banks)
         for r in want.best_per_scenario()]


# ------------------------------------------------------------ the CLI
def _cli(module, out, device_args, env_extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env_extra)
    subprocess.run([sys.executable, "-m", module, "--horizon", "5",
                    "--slots", "4", "--max-len", "512", "--banks", "1", "8",
                    "--json", str(out), *device_args],
                   check=True, cwd=ROOT, env=env, capture_output=True,
                   timeout=120)
    return json.loads(out.read_text())["rows"]


def test_traffic_cli_payload_matches_reference(tmp_path):
    """`--json` rows at the smoke sizes: every key, the offline energies
    within rel 1e-12 and the percentages derived from them within the
    1e-10 points that follows, the rest exactly."""
    got = _cli("repro_torch.launch.traffic", tmp_path / "t.json",
               ["--device", "cpu"], {})
    want = _cli("repro.launch.traffic", tmp_path / "j.json", [],
                {"JAX_PLATFORMS": "cpu"})
    assert len(got) == len(want) > 0
    assert {r["arch"] for r in got} == {"gpt2-xl", "dsr1d-qwen-1.5b"}
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            if k in ("e_oracle_j", "e_none_j"):
                close(g[k], w[k], k)
            elif k.endswith("_pct"):
                assert abs(g[k] - w[k]) <= 1e-10, k
            else:
                assert g[k] == w[k], k


def test_sweep_by_capacity_matches_reference(traces):
    sim_t, sim_j = traces["gpt2-xl"][0][4], traces["gpt2-xl"][1][4]
    m = min_capacity_mib(sim_t.trace.peak_needed())
    caps = [m, m + 16, m + 32]
    got = tsweep(sim_t.bundle, mem_name="kv", capacities_mib=caps,
                 banks=(1, 4, 16), device="cpu").by_capacity()
    want = jsweep(sim_j.bundle, mem_name="kv", capacities_mib=caps,
                  banks=(1, 4, 16)).by_capacity()
    assert list(got) == list(want) and len(got) > 1
    for c in got:
        g = [dataclasses.asdict(r) for r in got[c]]
        w = [dataclasses.asdict(r) for r in want[c]]
        close(g, w, "by_capacity")
        assert [r.banks for r in got[c]] == [1, 4, 16]
    assert list(got) == caps


def test_device_defaults_to_the_card():
    """Every Stage-II entry of the traffic modules takes `device=`, default
    the card, and a missing card raises rather than falling back."""
    import inspect

    import torch
    for fn in (tctl.compare, tctl.compare_grid, tcamp.fast_candidate_energies,
               tcamp.run_scenario, tcamp.run_campaign):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcamp.run_campaign(["dsr1d-qwen-1.5b"], horizon_s=2.0,
                               num_slots=2, max_len=256, banks=(1, 4))
