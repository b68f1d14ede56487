"""Online bank power-gating controller simulated against a live trace
(port of the reference package's `repro/traffic/controller.py`; host code
copied line for line, the offline legs on `device` through
`core.candidates.evaluate_candidates`).

Stage II's `core.gating.evaluate` is an *offline oracle*: it sees each idle
interval's full duration before deciding to gate, so it gates exactly the
runs that pass the break-even criterion. A deployable controller only knows
the past. The classic online policy (ski-rental / timeout) is implemented
here: a bank that has been idle for `hysteresis_multiple x break_even_s`
(per `core.cacti.characterize`) is gated off, and is woken — paying the
transition energy and exposing `WAKEUP_LATENCY_NS` to the consumer — the
moment demand returns. With hysteresis h = break-even this policy is
2-competitive; energy always satisfies

    oracle  <=  online        (the oracle skips exactly the leakage the
                               online controller burns while waiting out h)

and on traces whose gated idle runs exceed h + break_even the online result
also beats the no-gating baseline.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.banking import bank_activity, bank_on_matrix, idle_runs
from repro_torch.core.cacti import WAKEUP_LATENCY_NS, SramCharacterization, \
    characterize
from repro_torch.core.candidates import Candidate, evaluate_candidates
from repro_torch.core.gating import GatingResult, Policy
from repro_torch.sim.pss import AffineForecaster


@dataclass(frozen=True)
class ControllerConfig:
    alpha: float = 0.9                   # packing headroom (Eq. 1)
    hysteresis_multiple: float = 2.0     # x break-even before gating off
    wake_latency_s: float = WAKEUP_LATENCY_NS * 1e-9


@dataclass(frozen=True)
class ForecastConfig:
    """Knobs of the forecast leg (`simulate_online_forecast`).

    `window_s` trades noise immunity against reaction time of the fitted
    trend; `lead_s` is the pre-wake horizon — it bounds how early a bank
    may wake, so it also bounds the leakage one avoided violation costs
    (roughly ``lead_s x leak_w_per_bank``)."""
    window_s: float = 2.0                # trailing least-squares fit window
    lead_s: Optional[float] = None       # pre-wake horizon; None → window/20

    @property
    def lead(self) -> float:
        return self.lead_s if self.lead_s is not None else self.window_s / 20


@dataclass
class OnlineResult:
    """GatingResult + the online-only observables."""
    gating: GatingResult
    wake_violations: int                 # wakes on the critical path
    stall_s: float                       # total wake-up latency exposed
    hysteresis_s: float
    # forecast-leg observables (zero for the reactive controller)
    pre_wakes: int = 0                   # forecast-triggered early wakes
    early_wake_s: float = 0.0            # leakage seconds those wakes cost

    @property
    def e_total(self) -> float:
        return self.gating.e_total


def simulate_online(durations: np.ndarray, occupancy: np.ndarray, *,
                    capacity: int, banks: int,
                    cfg: Optional[ControllerConfig] = None,
                    n_reads: int = 0, n_writes: int = 0,
                    char: Optional[SramCharacterization] = None
                    ) -> OnlineResult:
    """Walk the trace causally with the timeout policy.

    Per idle run of length `r` with hysteresis `h`: the bank leaks for
    min(r, h); if r >= h it is gated for r - h (one off/on transition pair)
    and its wake at the end of the run is a latency violation unless the run
    closes the trace."""
    cfg = cfg or ControllerConfig()
    ch = char or characterize(capacity, banks)
    d = np.asarray(durations, np.float64)
    occ = np.asarray(occupancy)
    total_time = float(d.sum())
    h = cfg.hysteresis_multiple * ch.break_even_s

    e_dyn = n_reads * ch.e_read_j + n_writes * ch.e_write_j

    act = bank_activity(occ, cfg.alpha, capacity, banks)
    on = bank_on_matrix(act, banks)

    on_seconds = 0.0
    gated_seconds = 0.0
    n_sw = 0
    violations = 0
    for b in range(banks):
        busy = float(d[on[:, b]].sum())
        run_d, starts, ends = idle_runs(d, on[:, b])
        waited = np.minimum(run_d, h)            # leak while the timer runs
        gated = run_d - waited
        gates = gated > 0
        n_sw += int(gates.sum())
        gated_seconds += float(gated.sum())
        on_seconds += busy + float(waited.sum())
        # a gated run that ends inside the trace wakes on demand: latency hit
        violations += int((gates & (ends < len(d))).sum())

    stall = violations * cfg.wake_latency_s
    e_leak = ch.leak_w_per_bank * on_seconds
    e_sw = n_sw * ch.e_switch_j
    g = GatingResult(policy=f"online(h={cfg.hysteresis_multiple:g}xBE)",
                     alpha=cfg.alpha, capacity=capacity, banks=banks,
                     e_dyn=e_dyn, e_leak=e_leak, e_sw=e_sw,
                     n_transitions=n_sw, gated_bank_seconds=gated_seconds,
                     total_bank_seconds=banks * total_time,
                     area_mm2=ch.area_mm2)
    return OnlineResult(g, violations, stall, h)


def simulate_online_forecast(durations: np.ndarray, occupancy: np.ndarray, *,
                             capacity: int, banks: int,
                             cfg: Optional[ControllerConfig] = None,
                             fcfg: Optional[ForecastConfig] = None,
                             n_reads: int = 0, n_writes: int = 0,
                             char: Optional[SramCharacterization] = None
                             ) -> OnlineResult:
    """The timeout policy plus PSS-style affine pre-wake.

    Which idle runs get gated is identical to `simulate_online` (same
    hysteresis timer); the forecast only adds *speculative wakes inside
    gated runs*. While a bank sits gated, the controller fits the trailing
    occupancy trend with a causal affine least-squares extrapolator
    (:class:`repro_torch.sim.pss.AffineForecaster` — the PSS affinity trick
    pointed at time) and anchors the forecast at the *currently observed*
    occupancy: demand is imminent at a boundary when the trend is rising
    and ``occ_now + slope x lead`` crosses the bank's demand threshold
    (``occ > b * alpha * capacity / banks``, exactly `bank_activity`'s
    cut). The bank is held awake exactly while that signal holds and
    re-gates the moment it drops — a false pre-wake therefore leaks only
    for the segments it persisted, not for the rest of the run. A run
    whose final approach the bank spent awake (woken at least
    `wake_latency_s` before demand returned) turns its on-demand wake
    violation into `early_wake_s` leakage: the forecast trades bounded
    early leakage (~``lead x leak_w_per_bank`` per avoided violation)
    against critical-path stalls.

    Energy ordering: oracle <= online <= forecast on leakage-only terms is
    NOT guaranteed (a bad forecast can speculatively wake for nothing),
    but the extra leakage is bounded by the signal-active seconds and every
    speculative wake costs one extra transition pair — both reported."""
    cfg = cfg or ControllerConfig()
    fcfg = fcfg or ForecastConfig()
    ch = char or characterize(capacity, banks)
    d = np.asarray(durations, np.float64)
    occ = np.asarray(occupancy, np.float64)
    total_time = float(d.sum())
    h = cfg.hysteresis_multiple * ch.break_even_s
    lead = fcfg.lead

    e_dyn = n_reads * ch.e_read_j + n_writes * ch.e_write_j

    act = bank_activity(occ, cfg.alpha, capacity, banks)
    on = bank_on_matrix(act, banks)
    cum = np.concatenate([[0.0], np.cumsum(d)])
    usable = cfg.alpha * capacity / banks

    # the fit inputs are bank-independent: evaluate the trend slope at
    # every segment boundary once, then per-bank wake tests are just
    # threshold compares against that bank's demand cut. The forecast is
    # anchored at the observed occupancy (not the fitted intercept, which
    # lags it right after a drop): occ_now + slope x lead.
    fc = AffineForecaster(cum[:-1], occ, fcfg.window_s)
    slopes = np.array([fc.slope(float(t)) for t in cum[:-1]])
    fvals = occ + np.maximum(slopes, 0.0) * lead

    on_seconds = 0.0
    gated_seconds = 0.0
    n_sw = 0
    violations = 0
    pre_wakes = 0
    early_s = 0.0
    for b in range(banks):
        col = on[:, b]
        on_seconds += float(d[col].sum())            # busy segments
        run_d, starts, ends = idle_runs(d, col)
        thresh = b * usable
        for r, s, e in zip(run_d, starts, ends):
            if r <= h:
                on_seconds += r       # timer never expires: leak it out
                continue
            t_s, t_e = float(cum[s]), float(cum[e])
            # speculative-wake decision points: boundaries in the gated
            # region; the bank is awake through segment k iff the signal
            # held at boundary k, and re-gates when it drops
            k0 = int(np.searchsorted(cum[: len(d)], t_s + h, side="left"))
            ks = np.arange(k0, e)
            sig = (slopes[ks] > 0) & (fvals[ks] > thresh) if len(ks) \
                else np.zeros(0, bool)
            awake_s = float(d[ks[sig]].sum()) if sig.any() else 0.0
            wakes = int(np.count_nonzero(sig[1:] & ~sig[:-1])
                        + (1 if len(sig) and sig[0] else 0))
            on_seconds += h + awake_s
            gated_seconds += (r - h) - awake_s
            early_s += awake_s
            pre_wakes += wakes
            # transition pairs: the initial gate-off/wake-on pair plus one
            # per extra speculative wake (an on-demand wake is saved when
            # the bank is already awake at the run's end)
            n_sw += max(wakes + (0 if len(sig) and sig[-1] else 1), 1)
            if e < len(d):
                # the violation is avoided only if the bank spent the final
                # approach awake, woken >= wake_latency_s before demand
                if len(sig) and sig[-1]:
                    j = len(sig) - 1
                    while j > 0 and sig[j - 1]:
                        j -= 1
                    if t_e - float(cum[ks[j]]) < cfg.wake_latency_s:
                        violations += 1
                else:
                    violations += 1

    stall = violations * cfg.wake_latency_s
    e_leak = ch.leak_w_per_bank * on_seconds
    e_sw = n_sw * ch.e_switch_j
    g = GatingResult(policy=(f"forecast(h={cfg.hysteresis_multiple:g}xBE,"
                             f"w={fcfg.window_s:g}s)"),
                     alpha=cfg.alpha, capacity=capacity, banks=banks,
                     e_dyn=e_dyn, e_leak=e_leak, e_sw=e_sw,
                     n_transitions=n_sw, gated_bank_seconds=gated_seconds,
                     total_bank_seconds=banks * total_time,
                     area_mm2=ch.area_mm2)
    return OnlineResult(g, violations, stall, h,
                        pre_wakes=pre_wakes, early_wake_s=early_s)


@dataclass
class ControllerComparison:
    """online (reactive) vs offline-oracle vs no-gating on the same
    trace/(C,B); optionally also the forecast controller leg."""
    online: OnlineResult
    oracle: GatingResult
    none: GatingResult
    forecast: Optional[OnlineResult] = None

    @property
    def online_vs_none_pct(self) -> float:
        return 100.0 * (self.online.e_total / self.none.e_total - 1.0)

    @property
    def online_vs_oracle_pct(self) -> float:
        return 100.0 * (self.online.e_total / self.oracle.e_total - 1.0)

    @property
    def forecast_vs_oracle_pct(self) -> float:
        if self.forecast is None:
            return float("nan")
        return 100.0 * (self.forecast.e_total / self.oracle.e_total - 1.0)

    @property
    def forecast_vs_none_pct(self) -> float:
        if self.forecast is None:
            return float("nan")
        return 100.0 * (self.forecast.e_total / self.none.e_total - 1.0)

    def format(self) -> str:
        o, g, n = self.online, self.oracle, self.none
        out = (f"E[mJ] none={n.e_total*1e3:.1f} "
               f"oracle={g.e_total*1e3:.1f} "
               f"online={o.e_total*1e3:.1f} "
               f"({self.online_vs_none_pct:+.1f}% vs none, "
               f"{self.online_vs_oracle_pct:+.1f}% vs oracle)  "
               f"wakes={o.wake_violations} stall={o.stall_s*1e6:.1f}us")
        if self.forecast is not None:
            f = self.forecast
            out += (f"\n  forecast={f.e_total*1e3:.1f}mJ "
                    f"({self.forecast_vs_oracle_pct:+.1f}% vs oracle)  "
                    f"wakes={f.wake_violations} stall={f.stall_s*1e6:.1f}us "
                    f"pre_wakes={f.pre_wakes} "
                    f"early={f.early_wake_s*1e3:.2f}ms")
        return out


def _offline_candidates(capacity: int, banks: int, cfg: ControllerConfig,
                        oracle_policy: Optional[Policy]) -> List[Candidate]:
    """The two offline legs of one comparison as engine candidates."""
    pol = oracle_policy or Policy(
        "oracle", cfg.alpha, gate=True,
        min_gate_multiple=cfg.hysteresis_multiple)
    return [
        Candidate(capacity, banks, pol.alpha,
                  "gate" if pol.gate else "none", pol.min_gate_multiple,
                  label=pol.name),
        Candidate(capacity, banks, cfg.alpha, "none", label="none"),
    ]


def compare(durations: np.ndarray, occupancy: np.ndarray, *,
            capacity: int, banks: int, n_reads: int, n_writes: int,
            cfg: Optional[ControllerConfig] = None,
            fcfg: Optional[ForecastConfig] = None,
            oracle_policy: Optional[Policy] = None,
            device="cuda") -> ControllerComparison:
    """The paper-style three-way comparison at one (C, B) point.

    The oracle uses `min_gate_multiple == hysteresis_multiple` so both
    policies gate the same set of idle runs — the gap between them is then
    purely the leakage burned during the online timer. The offline legs run
    on the batched engine; grid sweeps should prefer `compare_grid`, which
    batches them across every (C, B) point in one call."""
    cfg = cfg or ControllerConfig()
    ch = characterize(capacity, banks)
    online = simulate_online(durations, occupancy, capacity=capacity,
                             banks=banks, n_reads=n_reads, n_writes=n_writes,
                             cfg=cfg, char=ch)
    fore = None
    if fcfg is not None:
        fore = simulate_online_forecast(
            durations, occupancy, capacity=capacity, banks=banks,
            n_reads=n_reads, n_writes=n_writes, cfg=cfg, fcfg=fcfg, char=ch)
    res = evaluate_candidates(
        durations, occupancy,
        _offline_candidates(capacity, banks, cfg, oracle_policy),
        n_reads=n_reads, n_writes=n_writes, device=device)
    return ControllerComparison(online, res.gating_result(0),
                                res.gating_result(1), forecast=fore)


def compare_grid(durations: np.ndarray, occupancy: np.ndarray, *,
                 points: Sequence[Tuple[int, int]], n_reads: int,
                 n_writes: int, cfg: Optional[ControllerConfig] = None,
                 fcfg: Optional[ForecastConfig] = None,
                 device="cuda"
                 ) -> Dict[Tuple[int, int], ControllerComparison]:
    """Three-way comparisons for every (capacity, banks) point at once.

    Both offline legs of every point go through one batched
    `evaluate_candidates` call; the causal online controller (inherently
    sequential over the trace) still runs per point."""
    cfg = cfg or ControllerConfig()
    cands: List[Candidate] = []
    for cap, b in points:
        cands.extend(_offline_candidates(cap, b, cfg, None))
    res = evaluate_candidates(durations, occupancy, cands, n_reads=n_reads,
                              n_writes=n_writes, device=device)
    out: Dict[Tuple[int, int], ControllerComparison] = {}
    for i, (cap, b) in enumerate(points):
        online = simulate_online(durations, occupancy, capacity=cap, banks=b,
                                 n_reads=n_reads, n_writes=n_writes, cfg=cfg)
        fore = None
        if fcfg is not None:
            fore = simulate_online_forecast(
                durations, occupancy, capacity=cap, banks=b,
                n_reads=n_reads, n_writes=n_writes, cfg=cfg, fcfg=fcfg)
        out[(cap, b)] = ControllerComparison(
            online, res.gating_result(2 * i), res.gating_result(2 * i + 1),
            forecast=fore)
    return out
