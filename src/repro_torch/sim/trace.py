"""Time-resolved occupancy traces and access statistics (Stage-I outputs),
copied from the reference package's `repro/sim/trace.py`."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class OccupancyTrace:
    """Piecewise-constant needed/obsolete occupancy of one memory over time.

    The engine is a list scheduler, so state mutations are emitted in
    processing order with non-monotonic simulated timestamps; we therefore
    record *delta events* (t, d_needed, d_obsolete) and integrate after a
    stable sort by time — the resulting step function is exact. `segments()`
    yields (duration, needed, obsolete, total) rows — the artifact Stage II
    consumes (Eq. 1/4 of the paper).

    Mutate only through `event()` / `extend()`: the integrated step function
    is cached and those are the invalidation points. `event()` appends to
    cheap Python tail lists (the DES hot path); `extend()` stores whole
    numpy chunks (the PSS/traffic bulk path), so million-event synthesized
    traces never round-trip through per-element Python objects. The
    `ev_times`/`ev_dneeded`/`ev_dobsolete` list views materialize chunks on
    first access; insertion order is preserved across both paths (ties in
    the stable time sort resolve in emission order)."""
    mem_name: str
    capacity: int
    _tail_t: List[float] = field(default_factory=list, repr=False,
                                 compare=False)
    _tail_dn: List[int] = field(default_factory=list, repr=False,
                                compare=False)
    _tail_do: List[int] = field(default_factory=list, repr=False,
                                compare=False)
    # sealed (t, dn, do) numpy chunks, in emission order, all before _tail_*
    _chunks: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = field(
        default_factory=list, repr=False, compare=False)
    # (n_events_at_integration, (t, n, o)) — see as_arrays()
    _cache: Optional[Tuple[int, Tuple[np.ndarray, np.ndarray, np.ndarray]]] \
        = field(default=None, init=False, repr=False, compare=False)

    def event(self, t: float, d_needed: int, d_obsolete: int) -> None:
        if d_needed == 0 and d_obsolete == 0:
            return
        self._tail_t.append(t)
        self._tail_dn.append(int(d_needed))
        self._tail_do.append(int(d_obsolete))
        self._cache = None

    def extend(self, times, d_needed, d_obsolete) -> None:
        """Bulk-append delta events (vectorized `event`). Rows where both
        deltas are zero are dropped, matching `event` semantics."""
        t = np.asarray(times, np.float64)
        dn = np.asarray(d_needed, np.int64)
        do = np.asarray(d_obsolete, np.int64)
        keep = (dn != 0) | (do != 0)
        if not keep.all():
            t, dn, do = t[keep], dn[keep], do[keep]
        if len(t) == 0:
            return
        self._seal_tail()
        self._chunks.append((t, dn, do))
        self._cache = None

    def _seal_tail(self) -> None:
        if self._tail_t:
            self._chunks.append((np.asarray(self._tail_t, np.float64),
                                 np.asarray(self._tail_dn, np.int64),
                                 np.asarray(self._tail_do, np.int64)))
            self._tail_t, self._tail_dn, self._tail_do = [], [], []

    def _materialize(self) -> None:
        """Fold sealed chunks back into the tail lists (list-view access)."""
        if not self._chunks:
            return
        self._chunks.append((np.asarray(self._tail_t, np.float64),
                             np.asarray(self._tail_dn, np.int64),
                             np.asarray(self._tail_do, np.int64)))
        self._tail_t = np.concatenate(
            [c[0] for c in self._chunks]).tolist()
        self._tail_dn = np.concatenate(
            [c[1] for c in self._chunks]).tolist()
        self._tail_do = np.concatenate(
            [c[2] for c in self._chunks]).tolist()
        self._chunks = []

    @property
    def ev_times(self) -> List[float]:
        self._materialize()
        return self._tail_t

    @property
    def ev_dneeded(self) -> List[int]:
        self._materialize()
        return self._tail_dn

    @property
    def ev_dobsolete(self) -> List[int]:
        self._materialize()
        return self._tail_do

    @property
    def n_events(self) -> int:
        return (sum(len(c[0]) for c in self._chunks) + len(self._tail_t))

    def events_since(self, n0: int):
        """(times, dn, do) arrays of the events appended after the first
        `n0` — O(tail) when no chunk was sealed since (the DES memoization
        recorder's case)."""
        sealed = sum(len(c[0]) for c in self._chunks)
        if n0 < sealed:
            self._materialize()
            sealed = 0
        i = n0 - sealed
        return (np.asarray(self._tail_t[i:], np.float64),
                np.asarray(self._tail_dn[i:], np.int64),
                np.asarray(self._tail_do[i:], np.int64))

    def _parts(self):
        """Raw event arrays in emission order, without materializing."""
        for c in self._chunks:
            yield c
        if self._tail_t:
            yield (np.asarray(self._tail_t, np.float64),
                   np.asarray(self._tail_dn, np.int64),
                   np.asarray(self._tail_do, np.int64))

    # ------------------------------------------------------------- views
    def as_arrays(self):
        """Sorted, integrated (times, needed, obsolete) step function.

        The result is cached until the next `event()`/`extend()` — repeated
        peak/segment queries on a finished trace integrate once instead of
        re-sorting the (possibly millions of) events per call. Treat the
        returned arrays as read-only."""
        n_ev = self.n_events
        if self._cache is not None and self._cache[0] == n_ev:
            return self._cache[1]
        parts = list(self._parts())
        if parts:
            t = np.concatenate([p[0] for p in parts])
            dn = np.concatenate([p[1] for p in parts])
            do = np.concatenate([p[2] for p in parts])
        else:
            t = np.zeros(0)
            dn = do = np.zeros(0, np.int64)
        order = np.argsort(t, kind="stable")
        t = t[order]
        n = np.cumsum(dn[order])
        o = np.cumsum(do[order])
        # collapse duplicate timestamps (keep last state at each time)
        if len(t):
            last = np.r_[t[1:] != t[:-1], True]
            t, n, o = t[last], n[last], o[last]
        self._cache = (n_ev, (t, n, o))
        return t, n, o

    def segments(self, end_time: float):
        """(durations, needed, obsolete, total) arrays, one row per segment."""
        t, n, o = self.as_arrays()
        if len(t) == 0:
            return (np.zeros(0), np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.int64))
        edges = np.append(t, max(end_time, t[-1]))
        dur = np.diff(edges)
        keep = dur > 0
        return dur[keep], n[keep], o[keep], (n + o)[keep]

    def peak_needed(self) -> int:
        _, n, _ = self.as_arrays()
        return int(n.max()) if len(n) else 0

    def peak_total(self) -> int:
        _, n, o = self.as_arrays()
        return int((n + o).max()) if len(n) else 0

    def time_weighted_mean(self, end_time: float) -> float:
        dur, n, o, tot = self.segments(end_time)
        if dur.sum() <= 0:
            return 0.0
        return float((tot * dur).sum() / dur.sum())

    def occupancy_series(self, end_time: float, use: str = "total"):
        """(durations, bytes) for Stage II; `use` selects needed|total."""
        dur, n, o, tot = self.segments(end_time)
        return dur, (n if use == "needed" else tot)

    # ------------------------------------------------------- transformations
    def merged(self, *others: "OccupancyTrace",
               mem_name: Optional[str] = None) -> "OccupancyTrace":
        """Superpose delta-event streams from several traces (e.g. per-tenant
        occupancy curves) into one. Exact: deltas commute under the stable
        time sort performed by `as_arrays`."""
        out = OccupancyTrace(mem_name or self.mem_name,
                             self.capacity + sum(t.capacity for t in others))
        for tr in (self, *others):
            for part in tr._parts():
                out.extend(*part)
        return out

    def time_integral(self, end_time: float, use: str = "total") -> float:
        """Byte-seconds under the needed|total occupancy curve."""
        dur, occ = self.occupancy_series(end_time, use=use)
        return float((occ.astype(np.float64) * dur).sum())

    def resampled(self, dt: float, end_time: float) -> "OccupancyTrace":
        """Snap the step function to a uniform `dt` grid (right-edge sample).

        Bounds the segment count to ~end_time/dt regardless of event density
        — the knob that keeps thousand-scenario campaign sweeps inside a
        fixed jit-padded shape. Peak occupancy is preserved up to the grid
        resolution (each grid cell reports its last value, so short spikes
        inside a cell may be clipped; choose dt accordingly)."""
        if dt <= 0:
            raise ValueError(f"dt must be positive, got {dt}")
        t, n, o = self.as_arrays()
        out = OccupancyTrace(self.mem_name, self.capacity)
        if len(t) == 0:
            return out
        grid = np.arange(0.0, max(end_time, t[-1]) + dt, dt)
        # value in force at each grid edge (step function is right-continuous)
        idx = np.searchsorted(t, grid, side="right") - 1
        gn = np.where(idx >= 0, n[np.maximum(idx, 0)], 0)
        go = np.where(idx >= 0, o[np.maximum(idx, 0)], 0)
        prev_n = prev_o = 0
        for g, vn, vo in zip(grid, gn, go):
            out.event(float(g), int(vn - prev_n), int(vo - prev_o))
            prev_n, prev_o = int(vn), int(vo)
        return out


def merge_traces(traces: Sequence["OccupancyTrace"],
                 mem_name: str = "merged") -> "OccupancyTrace":
    """Module-level convenience over `OccupancyTrace.merged`."""
    if not traces:
        return OccupancyTrace(mem_name, 0)
    return traces[0].merged(*traces[1:], mem_name=mem_name)


@dataclass
class AccessStats:
    reads_bytes: Dict[str, int] = field(default_factory=dict)
    writes_bytes: Dict[str, int] = field(default_factory=dict)
    access_width: int = 64         # bytes per SRAM access word

    def add_read(self, mem: str, b: int) -> None:
        self.reads_bytes[mem] = self.reads_bytes.get(mem, 0) + int(b)

    def add_write(self, mem: str, b: int) -> None:
        self.writes_bytes[mem] = self.writes_bytes.get(mem, 0) + int(b)

    def n_reads(self, mem: str) -> int:
        return -(-self.reads_bytes.get(mem, 0) // self.access_width)

    def n_writes(self, mem: str) -> int:
        return -(-self.writes_bytes.get(mem, 0) // self.access_width)


@dataclass
class TraceBundle:
    """The minimal Stage-I artifact contract consumed by Stage II.

    `sim.engine.SimResult` satisfies it structurally; the port's paged
    batcher emits it (`serve.paged.PagedContinuousBatcher.occupancy_bundle`),
    and `core.explorer.sweep` consumes either."""
    graph_name: str
    total_time: float
    traces: Dict[str, "OccupancyTrace"]
    access: "AccessStats"

    def peak_needed(self, mem: str = "kv") -> int:
        return self.traces[mem].peak_needed()


@dataclass
class OpStats:
    """Per-tag latency decomposition (paper Fig. 6)."""
    compute: Dict[str, float] = field(default_factory=dict)
    memory: Dict[str, float] = field(default_factory=dict)
    idle: Dict[str, float] = field(default_factory=dict)
    count: Dict[str, int] = field(default_factory=dict)

    def add(self, tag: str, compute: float, memory: float, idle: float):
        self.compute[tag] = self.compute.get(tag, 0.0) + compute
        self.memory[tag] = self.memory.get(tag, 0.0) + memory
        self.idle[tag] = self.idle.get(tag, 0.0) + idle
        self.count[tag] = self.count.get(tag, 0) + 1
