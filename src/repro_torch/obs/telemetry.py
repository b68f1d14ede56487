"""Zero-dependency telemetry: counters, gauges, histograms, spans; a copy
of the reference package's `repro/obs/telemetry.py`.

The serving/sim stack is instrumented through one :class:`Telemetry`
registry per engine (or the process-wide :func:`default_registry` for
aggregate counters like compile counts). Design constraints, in order:

  * **disabled is free** — every instrument holds a reference to its
    registry and checks one boolean before recording; ``tel.span(...)`` on
    a disabled registry returns a shared no-op context manager without
    allocating. Engines run with a disabled registry by default, so the
    hot decode path pays one branch per event.
  * **mergeable** — counters add, gauges sum (max-of-max rides along),
    histograms share fixed bucket boundaries so ``merge`` is exact on
    counts. Per-shard registries from a future mesh-sharded engine reduce
    into one fleet view with :meth:`Telemetry.merge`.
  * **clock-agnostic** — spans read ``Telemetry.clock``. Wall-clock users
    keep the ``time.perf_counter`` default; the serving batchers re-point
    the clock at their logical sim clock so spans land on the same
    timeline as the Stage-I `OccupancyTrace` (what makes the Perfetto
    export a *single* coherent view).

Histogram quantiles are estimated from fixed log-spaced buckets: the
estimate for any order statistic lies inside the bucket that truly
contains it (bucket counts are exact), clamped to the observed min/max —
the property the hypothesis suite pins down.
"""
from __future__ import annotations

import bisect
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def log_bucket_edges(lo: float = 1e-6, hi: float = 1e4,
                     per_decade: int = 5) -> Tuple[float, ...]:
    """Log-spaced bucket boundaries shared by every histogram of a kind —
    identical edges are what make cross-registry merges exact."""
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


DEFAULT_BUCKETS = log_bucket_edges()
# serving latencies: 10 µs .. 1000 s, 8 buckets per decade
LATENCY_BUCKETS = log_bucket_edges(1e-5, 1e3, per_decade=8)


class Counter:
    """Monotonic add-only metric. `value` may be int or float."""

    __slots__ = ("name", "_tel", "value")

    def __init__(self, name: str, tel: "Telemetry"):
        self.name = name
        self._tel = tel
        self.value = 0

    def inc(self, n=1) -> None:
        if self._tel.enabled:
            self.value += n


class Gauge:
    """Last-value metric; tracks the max ever set. Merges by summing the
    last values (per-shard residency gauges add up) and max-of-max."""

    __slots__ = ("name", "_tel", "value", "max_value")

    def __init__(self, name: str, tel: "Telemetry"):
        self.name = name
        self._tel = tel
        self.value = 0
        self.max_value = 0

    def set(self, v) -> None:
        if self._tel.enabled:
            self.value = v
            if v > self.max_value:
                self.max_value = v


class Histogram:
    """Fixed-bucket histogram with mergeable quantile estimates.

    Buckets are the half-open intervals between `edges` plus an underflow
    and an overflow bucket; `counts` has ``len(edges) + 1`` entries.
    Quantiles follow numpy's default convention (rank ``q * (n - 1)``,
    linear between the two bounding order statistics), with each order
    statistic located in its exact bucket and placed by within-bucket rank
    interpolation, clamped to the observed ``[min_value, max_value]``.

    Equality compares edges, counts and extrema — **not** `total`, whose
    float value depends on summation order (bulk vs scalar observes), so
    two registries that saw the same samples compare equal either way.
    """

    __slots__ = ("name", "_tel", "edges", "counts", "count", "total",
                 "min_value", "max_value")

    def __init__(self, name: str, tel: Optional["Telemetry"] = None,
                 edges: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self._tel = tel
        self.edges = tuple(float(e) for e in edges)
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.total = 0.0
        self.min_value = math.inf
        self.max_value = -math.inf

    # --------------------------------------------------------------- record
    @property
    def _enabled(self) -> bool:
        return self._tel is None or self._tel.enabled

    def observe(self, x: float, n: int = 1) -> None:
        if not self._enabled:
            return
        x = float(x)
        self.counts[bisect.bisect_right(self.edges, x)] += n
        self.count += n
        self.total += x * n
        if x < self.min_value:
            self.min_value = x
        if x > self.max_value:
            self.max_value = x

    def observe_array(self, xs: np.ndarray) -> None:
        """Vectorized bulk observe — the traffic fast-forward path records
        thousands of identical token gaps per window through this."""
        if not self._enabled or len(xs) == 0:
            return
        xs = np.asarray(xs, np.float64)
        idx = np.searchsorted(self.edges, xs, side="right")
        for b, c in zip(*np.unique(idx, return_counts=True)):
            self.counts[int(b)] += int(c)
        self.count += len(xs)
        self.total += float(xs.sum())
        lo, hi = float(xs.min()), float(xs.max())
        if lo < self.min_value:
            self.min_value = lo
        if hi > self.max_value:
            self.max_value = hi

    # -------------------------------------------------------------- queries
    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def bucket_bounds(self, x: float) -> Tuple[float, float]:
        """(lo, hi) edges of the bucket that holds value `x` (±inf at the
        ends) — the resolution limit of any estimate involving `x`."""
        b = bisect.bisect_right(self.edges, float(x))
        lo = self.edges[b - 1] if b > 0 else -math.inf
        hi = self.edges[b] if b < len(self.edges) else math.inf
        return lo, hi

    def _order_stat(self, i: int) -> float:
        """Estimate of the i-th (0-based) order statistic: exact bucket,
        within-bucket rank interpolation, clamped to observed extrema."""
        target = i + 1
        cum = 0
        for b, c in enumerate(self.counts):
            if c and cum + c >= target:
                lo = self.edges[b - 1] if b > 0 else self.min_value
                hi = self.edges[b] if b < len(self.edges) else self.max_value
                lo = max(lo, self.min_value)
                hi = min(hi, self.max_value)
                return lo + (hi - lo) * ((target - cum) / c)
            cum += c
        return self.max_value

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return math.nan
        k = min(max(q, 0.0), 1.0) * (self.count - 1)
        lo = self._order_stat(int(math.floor(k)))
        f = k - math.floor(k)
        if f == 0.0:
            return lo
        return lo * (1.0 - f) + self._order_stat(int(math.ceil(k))) * f

    # ---------------------------------------------------------------- merge
    def merge(self, other: "Histogram") -> None:
        if self.edges != other.edges:
            raise ValueError(
                f"histogram {self.name}: bucket edges differ, not mergeable")
        for b, c in enumerate(other.counts):
            self.counts[b] += c
        self.count += other.count
        self.total += other.total
        self.min_value = min(self.min_value, other.min_value)
        self.max_value = max(self.max_value, other.max_value)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Histogram):
            return NotImplemented
        return (self.edges == other.edges and self.counts == other.counts
                and self.count == other.count
                and self.min_value == other.min_value
                and self.max_value == other.max_value)

    def __repr__(self) -> str:
        return (f"Histogram({self.name!r}, n={self.count}, "
                f"p50={self.quantile(0.5):.3g}, p99={self.quantile(0.99):.3g})")


@dataclass
class Span:
    """One timed interval on the registry's clock. Zero-duration spans are
    rendered as instant events by the Perfetto exporter."""
    name: str
    t0: float
    t1: float
    attrs: Dict[str, object] = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class _NullSpan:
    """Shared no-op context manager — the whole cost of a disabled span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    __slots__ = ("_tel", "_name", "_attrs", "_t0")

    def __init__(self, tel: "Telemetry", name: str, attrs: Dict):
        self._tel = tel
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        self._t0 = self._tel.clock()
        return self

    def __exit__(self, *exc):
        tel = self._tel
        tel.spans.append(Span(self._name, self._t0, tel.clock(), self._attrs))
        return False


class Telemetry:
    """Registry of named instruments plus a span log.

    `clock` is any ``() -> float``; engines with a logical sim clock bind
    it so spans share the occupancy trace's time base. `record_spans`
    gates the span log separately from metrics — the process-wide default
    registry keeps counters on but spans off (unbounded growth across a
    long campaign is the failure mode that guards against).
    """

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter,
                 record_spans: bool = True):
        self.enabled = enabled
        self.clock = clock
        self.record_spans = record_spans
        self.spans: List[Span] = []
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._clock_owner: Optional[object] = None

    # ----------------------------------------------------------------- clock
    def bind_clock(self, clock: Callable[[], float], owner: object) -> None:
        """Point `self.clock` at an engine's logical time base, recording
        `owner` as the binding engine. A second engine binding the same
        registry raises instead of silently re-pointing the clock — the old
        failure mode corrupted the first engine's spans and SLO timelines
        mid-flight. To reuse a registry sequentially, call
        :meth:`release_clock` after the first engine drains."""
        if self._clock_owner is not None and self._clock_owner is not owner:
            raise RuntimeError(
                "telemetry clock is already bound by another engine; one "
                "registry records one timeline — use a separate Telemetry "
                "per engine (merge() them afterwards) or release_clock() "
                "when the first engine is done")
        self._clock_owner = owner
        self.clock = clock

    def release_clock(self) -> None:
        """Detach the bound engine and restore the wall clock, allowing a
        new engine to bind this registry."""
        self._clock_owner = None
        self.clock = time.perf_counter

    # ---------------------------------------------------------- instruments
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name, self)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, self)
        return g

    def histogram(self, name: str,
                  edges: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, self, edges)
        return h

    # ----------------------------------------------------------------- spans
    def span(self, name: str, **attrs):
        """``with tel.span("prefill", slot=i): ...`` — times the body on
        `self.clock`. Disabled path: one branch, shared no-op return."""
        if not (self.enabled and self.record_spans):
            return _NULL_SPAN
        return _SpanCtx(self, name, attrs)

    def add_span(self, name: str, t0: float, t1: float, **attrs) -> None:
        """Record a span with explicit timestamps (engines that advance a
        sim clock mid-body emit their spans this way)."""
        if self.enabled and self.record_spans:
            self.spans.append(Span(name, t0, t1, attrs))

    # ----------------------------------------------------------------- merge
    def merge(self, other: "Telemetry") -> "Telemetry":
        """Fold `other`'s instruments and spans into this registry (exact
        for counters/histograms; gauges sum last values). Returns self."""
        for name, c in other._counters.items():
            self.counter(name).value += c.value
        for name, g in other._gauges.items():
            mine = self.gauge(name)
            mine.value += g.value
            mine.max_value = max(mine.max_value, g.max_value)
        for name, h in other._histograms.items():
            self.histogram(name, h.edges).merge(h)
        self.spans.extend(other.spans)
        return self

    # ------------------------------------------------------------- reporting
    def snapshot(self) -> Dict[str, Dict]:
        """Plain-data view (JSON-serializable) of every instrument."""
        return {
            "counters": {n: c.value for n, c in sorted(self._counters.items())},
            "gauges": {n: {"value": g.value, "max": g.max_value}
                       for n, g in sorted(self._gauges.items())},
            "histograms": {
                n: {"count": h.count, "mean": h.mean,
                    "p50": h.quantile(0.5), "p90": h.quantile(0.9),
                    "p99": h.quantile(0.99)}
                for n, h in sorted(self._histograms.items())},
            "spans": len(self.spans),
        }

    def format(self) -> str:
        """Text metrics dump (the `obs report` CLI view)."""
        lines = ["-- counters " + "-" * 46]
        for n, c in sorted(self._counters.items()):
            lines.append(f"  {n:<44} {c.value}")
        if self._gauges:
            lines.append("-- gauges " + "-" * 48)
            for n, g in sorted(self._gauges.items()):
                lines.append(f"  {n:<44} {g.value} (max {g.max_value})")
        if self._histograms:
            lines.append("-- histograms " + "-" * 44)
            for n, h in sorted(self._histograms.items()):
                if h.count:
                    lines.append(
                        f"  {n:<34} n={h.count:<7} mean={h.mean:9.3g} "
                        f"p50={h.quantile(0.5):9.3g} "
                        f"p99={h.quantile(0.99):9.3g}")
                else:
                    lines.append(f"  {n:<34} n=0")
        by_name: Dict[str, Tuple[int, float]] = {}
        for s in self.spans:
            k, tot = by_name.get(s.name, (0, 0.0))
            by_name[s.name] = (k + 1, tot + s.dur)
        if by_name:
            lines.append("-- spans " + "-" * 49)
            for n, (k, tot) in sorted(by_name.items()):
                lines.append(f"  {n:<34} n={k:<7} total={tot:9.3g}s")
        return "\n".join(lines)


_DEFAULT: Optional[Telemetry] = None
_NOOP = Telemetry(enabled=False, record_spans=False)


def default_registry() -> Telemetry:
    """Process-wide registry backing aggregate counters (compile counts,
    DES/PSS totals). Metrics on, spans off — safe to grow for a process
    lifetime. Per-engine registries stay separate and mergeable."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Telemetry(enabled=True, record_spans=False)
    return _DEFAULT


def noop_registry() -> Telemetry:
    """The shared disabled registry engines default to — records nothing."""
    return _NOOP
