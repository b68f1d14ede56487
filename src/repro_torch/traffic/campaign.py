"""Traffic campaigns: intensity x model x (C, B, policy) sweeps + Pareto
(port of the reference package's `repro/traffic/campaign.py`; host code
copied line for line, with `device=` where the reference takes
`backend=`/`fast_backend=`).

Two evaluation paths over the same traffic-generated occupancy traces:

  * exact     — `controller.compare_grid`: the offline oracle and no-gating
                legs of every (C, B) point in one batched
                `core.candidates.evaluate_candidates` call, plus the causal
                online timeout controller per point (wake-latency
                violations included).
  * fast grid — per-candidate energy *lower bound* in one vectorized call
                (`core.candidates.lower_bound_energies`, the `bank_energy`
                kernel on the card): dynamic energy +
                required-bank leakage only, which bounds every policy from
                below. With `prune=True` it cuts the (C, B) grid before the
                exact phase — the right objective for thousand-scenario
                campaigns; the true argmin is never dropped.

Both paths run on `device`: the CUDA bank kernels on the card, their
plain float64 versions on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import resolve_arch
from repro_torch.core.candidates import lower_bound_energies, make_grid
from repro_torch.core.explorer import (DEFAULT_BANKS, MIB,  # noqa: F401
                                       min_capacity_mib)   # (re-exported)
from repro_torch.traffic.controller import (ControllerComparison,
                                            ControllerConfig, ForecastConfig,
                                            compare, compare_grid)
from repro_torch.traffic.generators import (LengthModel, generate,
                                            generate_workload)
from repro_torch.traffic.occupancy import (TrafficSim,
                                           simulate_prefix_traffic,
                                           simulate_spec_traffic,
                                           simulate_traffic,
                                           utilization_summary)


@dataclass(frozen=True)
class Scenario:
    """One cell of the campaign grid (arch x traffic point).

    `workload` selects a shared-prefix family ("chat_sysprompt", "fewshot",
    "agentic_fanout") or "plain" for unstructured traffic. Shared workloads
    run through the page-granular prefix-sharing simulator; the (C, B) grid
    is then evaluated against *physical* occupancy — the logical trace
    rides along in the sim bundle for headroom reporting."""
    arch: str
    arrival: str = "poisson"
    rate: float = 4.0
    seed: int = 0
    horizon_s: float = 30.0
    num_slots: int = 8
    max_len: int = 2048
    workload: str = "plain"
    prefix_len: int = 512
    sharing: int = 8
    page_size: int = 16
    kv_dtype: str = "bf16"
    # speculative decoding (model-free spec simulator when speculate_k set)
    speculate_k: Optional[int] = None
    spec_acceptance: float = 0.7
    draft_kv_frac: float = 0.5

    @property
    def kv_dtype_bytes(self) -> int:
        """Data bytes per cached K/V element for the model-free sims.

        Scale overhead of the int8 pools is excluded here deliberately: the
        sims account data bytes only, so quantized traces stay exact
        integer ratios of the bf16 baseline (the golden-trace invariant)."""
        return {"fp32": 4, "bf16": 2, "fp16": 2, "int8": 1, "fp8": 1}[
            self.kv_dtype]

    @property
    def traffic_key(self) -> Tuple:
        """Scenarios sharing this key see byte-identical request streams."""
        return (self.arrival, self.rate, self.seed, self.horizon_s,
                self.workload, self.prefix_len, self.sharing,
                self.speculate_k, self.spec_acceptance, self.draft_kv_frac)


@dataclass
class CampaignRow:
    scenario: Scenario
    capacity_mib: int
    banks: int
    comparison: ControllerComparison
    peak_mib: float
    mean_mib: float
    p95_latency_s: float
    # serving SLO percentiles of the scenario's traffic (same for every
    # (C, B) row of one scenario — the grid reprices energy, not latency)
    ttft_p50_s: float = 0.0
    ttft_p99_s: float = 0.0
    tbt_p50_s: float = 0.0
    tbt_p99_s: float = 0.0
    # streaming BankEnergyMeter report for the scenario's metered candidate
    # (same for every (C, B) row of one scenario; None when no --meter)
    energy: Optional[object] = None

    @property
    def e_online(self) -> float:
        return self.comparison.online.e_total

    @property
    def e_oracle(self) -> float:
        return self.comparison.oracle.e_total

    @property
    def e_none(self) -> float:
        return self.comparison.none.e_total

    # first-class controller SLO columns: wake-latency violations and the
    # stall seconds they expose, reactive vs forecast leg
    @property
    def wakes_reactive(self) -> int:
        return self.comparison.online.wake_violations

    @property
    def stall_reactive_s(self) -> float:
        return self.comparison.online.stall_s

    @property
    def e_forecast(self) -> float:
        f = self.comparison.forecast
        return float("nan") if f is None else f.e_total

    @property
    def wakes_forecast(self) -> Optional[int]:
        f = self.comparison.forecast
        return None if f is None else f.wake_violations

    @property
    def stall_forecast_s(self) -> float:
        f = self.comparison.forecast
        return float("nan") if f is None else f.stall_s


@dataclass
class CampaignReport:
    rows: List[CampaignRow] = field(default_factory=list)
    fast_grid: Dict[Tuple, np.ndarray] = field(default_factory=dict)
    sims: Dict[Tuple, TrafficSim] = field(default_factory=dict)

    def best_per_scenario(self) -> List[CampaignRow]:
        best: Dict[Tuple, CampaignRow] = {}
        for r in self.rows:
            k = (r.scenario.arch, r.scenario.traffic_key)
            if k not in best or r.e_online < best[k].e_online:
                best[k] = r
        return list(best.values())

    def pareto_points(self) -> List[Tuple[float, float, str, int, int]]:
        """(area, online energy, arch, C, B) — the Fig.-9 scatter under
        traffic instead of a single inference."""
        return [(r.comparison.online.gating.area_mm2, r.e_online,
                 r.scenario.arch, r.capacity_mib, r.banks)
                for r in self.rows]

    def format(self) -> str:
        has_fc = any(r.comparison.forecast is not None for r in self.rows)
        head = (f"{'arch':>20} {'arrival':>8} {'rate':>5} {'C':>5} {'B':>3} "
                f"{'peak':>7} {'E_none':>8} {'E_oracle':>9} {'E_online':>9} "
                f"{'dNone%':>7} {'dOrcl%':>7} {'wakes':>6} {'stall_us':>8}")
        if has_fc:
            head += f" {'E_fcast':>9} {'dFOrcl%':>8} {'fwakes':>6} " \
                    f"{'fstall_us':>9}"
        head += (f" {'p95[s]':>7} {'ttft50':>7} {'ttft99':>7} "
                 f"{'tbt50':>8} {'tbt99':>8}")
        lines = [head]
        for r in self.rows:
            c = r.comparison
            line = (
                f"{r.scenario.arch:>20} {r.scenario.arrival:>8} "
                f"{r.scenario.rate:>5.1f} {r.capacity_mib:>5} {r.banks:>3} "
                f"{r.peak_mib:>6.1f}M {r.e_none*1e3:>8.1f} "
                f"{r.e_oracle*1e3:>9.1f} {r.e_online*1e3:>9.1f} "
                f"{c.online_vs_none_pct:>+7.1f} {c.online_vs_oracle_pct:>+7.1f} "
                f"{r.wakes_reactive:>6} {r.stall_reactive_s*1e6:>8.1f}")
            if has_fc:
                if c.forecast is not None:
                    line += (f" {r.e_forecast*1e3:>9.1f} "
                             f"{c.forecast_vs_oracle_pct:>+8.1f} "
                             f"{r.wakes_forecast:>6} "
                             f"{r.stall_forecast_s*1e6:>9.1f}")
                else:
                    line += f" {'-':>9} {'-':>8} {'-':>6} {'-':>9}"
            line += (f" {r.p95_latency_s:>7.2f} "
                     f"{r.ttft_p50_s:>7.3f} {r.ttft_p99_s:>7.3f} "
                     f"{r.tbt_p50_s:>8.4f} {r.tbt_p99_s:>8.4f}")
            lines.append(line)
        # streaming-meter footer: one block per metered scenario (J/request
        # percentiles, wake causes, per-tenant energy breakdown)
        seen = set()
        for r in self.rows:
            if r.energy is None:
                continue
            k = (r.scenario.arch, r.scenario.traffic_key)
            if k in seen:
                continue
            seen.add(k)
            lines.append(f"-- {r.scenario.arch} "
                         f"{r.scenario.arrival}@{r.scenario.rate:g}/s --")
            lines.append(r.energy.format())
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Vectorized fast path
# ---------------------------------------------------------------------------

def fast_candidate_energies(durations: np.ndarray, occupancy: np.ndarray, *,
                            capacities_mib: Sequence[int],
                            banks: Sequence[int], alpha: float,
                            n_reads: int, n_writes: int,
                            device="cuda") -> np.ndarray:
    """Per-candidate energy lower bound for every (C, B) in one call of the
    `bank_energy` kernel on `device`.

    Returns shape (len(capacities) * len(banks),) J, ordered like
    `candidate_grid` (C-major): dynamic energy + leakage of the banks the
    occupancy *requires* per segment. Switch energy is deliberately excluded
    — charging it per idle run can exceed what any threshold policy pays on
    sub-break-even runs, which would break the bound. Without it the value
    is a true lower bound on `gating.evaluate` under every policy (required
    leakage and dynamic accesses are unavoidable, switching is >= 0), which
    is what makes it safe for pruning. Thin wrapper over the engine's
    `lower_bound_energies` — one implementation serves campaign pruning,
    `evaluate_candidates(prune=True)` and the sweep CLIs."""
    cands = make_grid([int(c * MIB) for c in capacities_mib], banks,
                      alphas=(alpha,))
    return lower_bound_energies(durations, occupancy, cands,
                                n_reads=n_reads, n_writes=n_writes,
                                device=device)


# ---------------------------------------------------------------------------
# Campaign runner
# ---------------------------------------------------------------------------

def run_scenario(scn: Scenario, *, capacities_mib: Optional[Sequence[int]],
                 banks: Sequence[int], ctrl: ControllerConfig,
                 fcfg: Optional[ForecastConfig] = None,
                 lengths: Optional[LengthModel] = None,
                 resample_dt: Optional[float] = None,
                 device="cuda", prune: bool = False,
                 prune_margin: float = 1e-3,
                 fidelity: str = "auto",
                 meter_spec: Optional[str] = None,
                 telemetry=None) -> Tuple[
                     TrafficSim, List[CampaignRow], np.ndarray]:
    """Simulate one scenario's traffic, then evaluate its (C, B) grid.

    Both offline legs of every (C, B) point run through one batched
    `compare_grid` call. With `prune=True`, the lower-bound grid cuts
    the candidate set first: a point survives only if its bound does not
    exceed the incumbent's exact online energy by `prune_margin` (relative);
    pruned points — which cannot win under any policy — get no rows."""
    from repro_torch.obs.telemetry import noop_registry
    tel = telemetry if telemetry is not None else noop_registry()
    cfg = resolve_arch(scn.arch)
    lengths = lengths or LengthModel(max_len=scn.max_len)
    meter = None
    if meter_spec is not None:
        from repro_torch.obs.energy import BankEnergyMeter
        meter = BankEnergyMeter.from_spec(meter_spec, telemetry=telemetry)
    with tel.span("campaign.simulate", arch=scn.arch, rate=scn.rate):
        if scn.speculate_k is not None:
            if scn.workload != "plain":
                raise ValueError(
                    "speculate_k only composes with workload='plain': the "
                    "model-free spec and prefix-sharing simulators are "
                    "separate channels")
            reqs = generate(scn.arrival, scn.rate, scn.horizon_s,
                            seed=scn.seed, lengths=lengths)
            sim = simulate_spec_traffic(
                cfg, reqs, num_slots=scn.num_slots,
                page_size=scn.page_size, max_len=scn.max_len,
                spec_k=scn.speculate_k, acceptance=scn.spec_acceptance,
                draft_kv_frac=scn.draft_kv_frac, seed=scn.seed,
                kv_dtype_bytes=scn.kv_dtype_bytes, meter=meter)
        elif scn.workload != "plain":
            reqs = generate_workload(scn.workload, scn.rate, scn.horizon_s,
                                     seed=scn.seed, lengths=lengths,
                                     arrival=scn.arrival,
                                     prefix_len=scn.prefix_len,
                                     sharing=scn.sharing, fanout=scn.sharing)
            sim = simulate_prefix_traffic(cfg, reqs, num_slots=scn.num_slots,
                                          page_size=scn.page_size,
                                          max_len=scn.max_len, seed=scn.seed,
                                          kv_dtype_bytes=scn.kv_dtype_bytes,
                                          meter=meter)
        else:
            reqs = generate(scn.arrival, scn.rate, scn.horizon_s,
                            seed=scn.seed, lengths=lengths)
            sim = simulate_traffic(cfg, reqs, num_slots=scn.num_slots,
                                   max_len=scn.max_len, fidelity=fidelity,
                                   kv_dtype_bytes=scn.kv_dtype_bytes,
                                   meter=meter)
    trace = sim.trace
    if resample_dt:
        trace = trace.resampled(resample_dt, sim.total_time)
    dur, occ = trace.occupancy_series(sim.total_time, use="needed")
    n_r = sim.bundle.access.n_reads("kv")
    n_w = sim.bundle.access.n_writes("kv")
    peak = trace.peak_needed()

    if capacities_mib is None:
        lo = max(min_capacity_mib(peak), 16)
        capacities_mib = sorted({lo, 2 * lo})

    with tel.span("campaign.fast_grid", arch=scn.arch,
                  n_points=len(capacities_mib) * len(banks)):
        fast = fast_candidate_energies(
            dur, occ, capacities_mib=list(capacities_mib), banks=list(banks),
            alpha=ctrl.alpha, n_reads=n_r, n_writes=n_w, device=device)

    points = [(int(c_mib * MIB), b)
              for c_mib in capacities_mib for b in banks
              if int(c_mib * MIB) >= peak]
    precomputed = {}
    if prune and len(points) > 1:
        # fast grid is C-major over (capacities x banks), like `points`
        lb = {(int(c_mib * MIB), b): fast[i]
              for i, (c_mib, b) in enumerate(
                  (c, b) for c in capacities_mib for b in banks)}
        best = min(points, key=lambda p: lb[p])
        inc = compare(dur, occ, capacity=best[0], banks=best[1],
                      n_reads=n_r, n_writes=n_w, cfg=ctrl, fcfg=fcfg,
                      device=device)
        precomputed[best] = inc        # incumbent is already fully evaluated
        cutoff = inc.online.e_total * (1.0 + prune_margin)
        points = [p for p in points if lb[p] <= cutoff or p == best]

    with tel.span("campaign.compare_grid", arch=scn.arch,
                  n_points=len(points)):
        comparisons = compare_grid(
            dur, occ, points=[p for p in points if p not in precomputed],
            n_reads=n_r, n_writes=n_w, cfg=ctrl, fcfg=fcfg, device=device)
    comparisons.update(precomputed)
    util = utilization_summary(sim)
    energy_rep = None
    if meter is not None:
        # credit forecast-leg pre-wakes of the metered (C, B) point, when
        # that point was part of the compared grid
        mpoint = (meter.capacity, meter.banks)
        comp = comparisons.get(mpoint)
        if comp is not None and comp.forecast is not None:
            meter.note_prewake(comp.forecast.pre_wakes)
        energy_rep = meter.report(sim.total_time,
                                  n_reads=n_r, n_writes=n_w)
    rows = [CampaignRow(scn, cap // MIB, b, comparisons[(cap, b)],
                        peak_mib=util["peak_bytes"] / MIB,
                        mean_mib=util["mean_bytes"] / MIB,
                        p95_latency_s=util["p95_latency_s"],
                        ttft_p50_s=util["ttft_p50_s"],
                        ttft_p99_s=util["ttft_p99_s"],
                        tbt_p50_s=util["tbt_p50_s"],
                        tbt_p99_s=util["tbt_p99_s"],
                        energy=energy_rep)
            for cap, b in points]
    tel.counter("campaign.scenarios").inc()
    tel.counter("campaign.rows").inc(len(rows))
    return sim, rows, fast


def run_campaign(archs: Sequence[str], *, arrivals: Sequence[str] = ("poisson",),
                 rates: Sequence[float] = (4.0,), seeds: Sequence[int] = (0,),
                 horizon_s: float = 30.0, num_slots: int = 8,
                 max_len: int = 2048,
                 capacities_mib: Optional[Sequence[int]] = None,
                 banks: Sequence[int] = DEFAULT_BANKS,
                 ctrl: Optional[ControllerConfig] = None,
                 fcfg: Optional[ForecastConfig] = None,
                 lengths: Optional[LengthModel] = None,
                 resample_dt: Optional[float] = None,
                 device="cuda",
                 prune: bool = False,
                 fidelity: str = "auto",
                 workload: str = "plain",
                 prefix_len: int = 512,
                 sharing: int = 8,
                 page_size: int = 16,
                 kv_dtype: str = "bf16",
                 speculate_k: Optional[int] = None,
                 spec_acceptance: float = 0.7,
                 draft_kv_frac: float = 0.5,
                 meter_spec: Optional[str] = None,
                 telemetry=None) -> CampaignReport:
    """The full grid. Identical (arrival, rate, seed) cells share one request
    stream across architectures, so MHA-vs-GQA rows are directly comparable."""
    ctrl = ctrl or ControllerConfig()
    report = CampaignReport()
    for arrival in arrivals:
        for rate in rates:
            for seed in seeds:
                for arch in archs:
                    scn = Scenario(arch=arch, arrival=arrival, rate=rate,
                                   seed=seed, horizon_s=horizon_s,
                                   num_slots=num_slots, max_len=max_len,
                                   workload=workload, prefix_len=prefix_len,
                                   sharing=sharing, page_size=page_size,
                                   kv_dtype=kv_dtype,
                                   speculate_k=speculate_k,
                                   spec_acceptance=spec_acceptance,
                                   draft_kv_frac=draft_kv_frac)
                    sim, rows, fast = run_scenario(
                        scn, capacities_mib=capacities_mib, banks=banks,
                        ctrl=ctrl, fcfg=fcfg, lengths=lengths,
                        resample_dt=resample_dt,
                        device=device,
                        prune=prune, fidelity=fidelity,
                        meter_spec=meter_spec, telemetry=telemetry)
                    key = (arch, scn.traffic_key)
                    report.sims[key] = sim
                    report.rows.extend(rows)
                    report.fast_grid[key] = fast
    return report
