"""Per-request serving SLOs computed from request timelines; a copy of the
reference package's `repro/obs/slo.py`.

The serving engines stamp a :class:`RequestTimeline` per request (on their
logical sim clock — the same time base as the Stage-I occupancy trace) and
feed it to an :class:`SLOTracker` at retirement. The tracker folds three
latency distributions into registry histograms:

  * **TTFT**  — submit to first token (queue wait + prefill);
  * **TBT**   — gap between consecutive emitted tokens (the streaming
    cadence users actually feel);
  * **e2e**   — submit to retirement.

Percentiles come from the mergeable fixed-bucket histograms, so per-shard
trackers reduce into fleet SLOs exactly like any other registry metric.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.obs.telemetry import LATENCY_BUCKETS, Histogram, Telemetry


@dataclass
class RequestTimeline:
    """Lifecycle timestamps of one request on the engine's clock."""
    rid: int
    submit_t: float
    admit_t: float = math.nan          # left the queue (prefill starts)
    first_token_t: float = math.nan    # prefill's argmax emitted token #1
    finish_t: float = math.nan
    token_ts: List[float] = field(default_factory=list)
    # times this request was preempted and requeued; the admit/token stamps
    # above always describe the final (completed) admission
    preemptions: int = 0
    # joules attributed to this request by a BankEnergyMeter (NaN = no
    # meter attached to the engine)
    energy_j: float = math.nan

    def reset_admission(self) -> None:
        """Roll the timeline back to the queued state after a preemption:
        submit_t survives (TTFT/e2e keep charging the requeue wait), the
        admission-scoped stamps are cleared for the re-prefill."""
        self.preemptions += 1
        self.admit_t = math.nan
        self.first_token_t = math.nan
        self.token_ts.clear()

    @property
    def ttft_s(self) -> float:
        return self.first_token_t - self.submit_t

    @property
    def e2e_s(self) -> float:
        return self.finish_t - self.submit_t

    def gaps(self) -> np.ndarray:
        """Inter-token gaps (empty for single-token requests)."""
        if len(self.token_ts) < 2:
            return np.zeros(0)
        return np.diff(np.asarray(self.token_ts))


@dataclass
class SLOSummary:
    """Headline percentiles — what `PagedStats`, campaign rows and the
    `obs` CLI surface next to energy."""
    n_requests: int = 0
    ttft_p50_s: float = 0.0
    ttft_p90_s: float = 0.0
    ttft_p99_s: float = 0.0
    tbt_p50_s: float = 0.0
    tbt_p90_s: float = 0.0
    tbt_p99_s: float = 0.0
    e2e_p50_s: float = 0.0
    e2e_p90_s: float = 0.0
    e2e_p99_s: float = 0.0
    # bytes-based KV occupancy (physical, i.e. after quantization /
    # sharing): filled by engines that own a Stage-I ledger, zero otherwise
    kv_peak_bytes: float = 0.0
    kv_mean_bytes: float = 0.0
    # per-request energy attribution (BankEnergyMeter), zero without a meter
    energy_p50_j: float = 0.0
    energy_p90_j: float = 0.0
    energy_p99_j: float = 0.0
    energy_per_tok_p50_j: float = 0.0
    energy_per_tok_p90_j: float = 0.0
    energy_per_tok_p99_j: float = 0.0

    def format(self) -> str:
        head = f"{'metric':<22} {'p50':>10} {'p90':>10} {'p99':>10}"
        rows = [
            ("ttft [s]", self.ttft_p50_s, self.ttft_p90_s, self.ttft_p99_s),
            ("time-between-tok [s]", self.tbt_p50_s, self.tbt_p90_s,
             self.tbt_p99_s),
            ("e2e latency [s]", self.e2e_p50_s, self.e2e_p90_s,
             self.e2e_p99_s),
        ]
        lines = [f"serving SLOs over {self.n_requests} requests", head]
        lines += [f"{n:<22} {a:>10.4g} {b:>10.4g} {c:>10.4g}"
                  for n, a, b, c in rows]
        if self.kv_peak_bytes:
            lines.append(
                f"{'kv occupancy [MiB]':<22} peak "
                f"{self.kv_peak_bytes / 2**20:.3f}  mean "
                f"{self.kv_mean_bytes / 2**20:.3f}")
        if self.energy_p99_j:
            lines.append(f"{'energy [mJ/request]':<22} "
                         f"{self.energy_p50_j * 1e3:>10.4g} "
                         f"{self.energy_p90_j * 1e3:>10.4g} "
                         f"{self.energy_p99_j * 1e3:>10.4g}")
        if self.energy_per_tok_p99_j:
            lines.append(f"{'energy [mJ/token]':<22} "
                         f"{self.energy_per_tok_p50_j * 1e3:>10.4g} "
                         f"{self.energy_per_tok_p90_j * 1e3:>10.4g} "
                         f"{self.energy_per_tok_p99_j * 1e3:>10.4g}")
        return "\n".join(lines)


def _q(h: Histogram, q: float) -> float:
    v = h.quantile(q)
    return 0.0 if math.isnan(v) else v


def summarize_histograms(ttft: Histogram, tbt: Histogram,
                         e2e: Histogram) -> SLOSummary:
    return SLOSummary(
        n_requests=ttft.count,
        ttft_p50_s=_q(ttft, 0.5), ttft_p90_s=_q(ttft, 0.9),
        ttft_p99_s=_q(ttft, 0.99),
        tbt_p50_s=_q(tbt, 0.5), tbt_p90_s=_q(tbt, 0.9),
        tbt_p99_s=_q(tbt, 0.99),
        e2e_p50_s=_q(e2e, 0.5), e2e_p90_s=_q(e2e, 0.9),
        e2e_p99_s=_q(e2e, 0.99))


class SLOTracker:
    """Folds retired request timelines into TTFT/TBT/e2e histograms
    registered on `tel` under ``{prefix}.ttft_s`` etc."""

    def __init__(self, tel: Telemetry, prefix: str = "serve"):
        self.ttft = tel.histogram(f"{prefix}.ttft_s", LATENCY_BUCKETS)
        self.tbt = tel.histogram(f"{prefix}.tbt_s", LATENCY_BUCKETS)
        self.e2e = tel.histogram(f"{prefix}.e2e_s", LATENCY_BUCKETS)

    def observe(self, tl: RequestTimeline) -> None:
        self.ttft.observe(tl.ttft_s)
        self.e2e.observe(tl.e2e_s)
        g = tl.gaps()
        if len(g):
            self.tbt.observe_array(g)

    def summary(self) -> SLOSummary:
        return summarize_histograms(self.ttft, self.tbt, self.e2e)


def percentile_summary(ttft_s: Optional[List[float]] = None,
                       tbt_hist: Optional[Histogram] = None,
                       e2e_s: Optional[List[float]] = None) -> SLOSummary:
    """SLO summary from raw samples where lists already exist (the
    model-free traffic sims keep latency lists for other consumers)."""
    def pct(xs, q):
        return float(np.percentile(xs, q)) if xs else 0.0

    out = SLOSummary(n_requests=len(ttft_s or []))
    if ttft_s:
        out.ttft_p50_s = pct(ttft_s, 50)
        out.ttft_p90_s = pct(ttft_s, 90)
        out.ttft_p99_s = pct(ttft_s, 99)
    if tbt_hist is not None and tbt_hist.count:
        out.tbt_p50_s = _q(tbt_hist, 0.5)
        out.tbt_p90_s = _q(tbt_hist, 0.9)
        out.tbt_p99_s = _q(tbt_hist, 0.99)
    if e2e_s:
        out.e2e_p50_s = pct(e2e_s, 50)
        out.e2e_p90_s = pct(e2e_s, 90)
        out.e2e_p99_s = pct(e2e_s, 99)
    return out


def attach_energy_percentiles(summary: SLOSummary, request_j,
                              tokens_by_rid=None) -> SLOSummary:
    """Fold a BankEnergyMeter's per-request charges into an SLO summary:
    J/request percentiles, and J/token when token counts are known."""
    js = [j for j in request_j.values()]
    if not js:
        return summary
    summary.energy_p50_j = float(np.percentile(js, 50))
    summary.energy_p90_j = float(np.percentile(js, 90))
    summary.energy_p99_j = float(np.percentile(js, 99))
    if tokens_by_rid:
        per_tok = [j / max(int(tokens_by_rid.get(rid, 1)), 1)
                   for rid, j in request_j.items()]
        summary.energy_per_tok_p50_j = float(np.percentile(per_tok, 50))
        summary.energy_per_tok_p90_j = float(np.percentile(per_tok, 90))
        summary.energy_per_tok_p99_j = float(np.percentile(per_tok, 99))
    return summary
