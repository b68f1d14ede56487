"""Periodic-steady-state (PSS) Stage-I decode fast path; a copy of the
reference package's `repro/sim/pss.py`, its `sim.pss.*` counters included.

Decode is a long, highly repetitive memory-bound phase: step t differs from
step t+1 only in the KV-cache context length, and every tensor size, MAC
count and delta-event magnitude in the step graph is an *affine* function of
that context length (scores are Bt*H*ctx bytes, the KV cache Bt*ctx*K*hd,
attention MACs Bt*H*hd*ctx, ...). The PSS path exploits this:

  1. run the exact DES at a few *probe* context lengths — the horizon
     endpoints plus interior validation probes
     (`core.workload.decode_probe_contexts`);
  2. validate affinity on the **structural** event stream (graph-driven
     allocations and needed→obsolete flips): every probe must emit the same
     number of structural events per memory, with integer occupancy deltas
     and access counters whose per-context slopes are exactly integral and
     identical across probe brackets, and zero capacity write-backs;
  3. synthesize every non-probe step by affine interpolation of the probe
     pattern, tile the per-step patterns with cumulative step latencies,
     and bulk-integrate through `OccupancyTrace.extend`.

Capacity-eviction **drop** events (pure obsolete removals, `d_needed == 0,
d_obsolete < 0`) are the one state-dependent part of a step: full-size
models stream more weight bytes per step than the SRAM holds, and the victim
count jumps by one at discrete context thresholds, so drops are only
piecewise constant in count. They cost no simulated time and never touch the
needed curve, so interior steps borrow the bracket-low probe's drop pattern
verbatim (time-scaled); a failing *structural* bracket is adaptively
bisected and re-validated until affine or the probe budget is exhausted
(`fidelity="auto"` then falls back to the exact per-step path,
`fidelity="pss"` raises).

Every step ends with a synthetic **drain** event returning both occupancy
buckets to zero at the step's latency: tiled steps are independent DES runs
of the per-step graph (each re-stages its working set), so without the drain
the horizon baseline would grow by each step's residual resident bytes. The
drain makes the tiled trace the time-resolved sequence of per-step occupancy
humps Stage II expects, in both the exact and the PSS path.

Exactness contract:
  * at probe context lengths the synthesized per-step event stream is the
    probe's own DES output (plus its drain) — bit-exact
    (`DecodeSimResult.step_events`);
  * between probes the **needed** occupancy curve is exact whenever the DES
    is affine in context length (the validated regime): needed deltas are
    all structural. Obsolete occupancy is exact at probes and off between
    them by at most the drop-pattern difference across the bracket (one
    eviction victim, bounded by the largest weight-slab size); each step
    still drains to zero, so the error never accumulates across steps;
  * event *timestamps* are interpolated and may deviate by at most one
    refill-latency charge per transfer per step (`REFILL_BYTES` ceil kinks)
    plus float rounding — asserted at interior probes via `time_rtol`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.workload import build_decode_graph, decode_probe_contexts
from repro_torch.sim.accelerator import AcceleratorConfig
from repro_torch.sim.engine import SimResult, simulate
from repro_torch.sim.trace import AccessStats, OccupancyTrace

FIDELITIES = ("exact", "pss", "auto")

Stream = Tuple[np.ndarray, np.ndarray, np.ndarray]    # times, dn, do


def _split(ev: Stream) -> Tuple[Stream, Stream]:
    """(structural, drops): drops are pure obsolete evictions."""
    t, dn, do = ev
    d = (dn == 0) & (do < 0)
    return (t[~d], dn[~d], do[~d]), (t[d], dn[d], do[d])


def _with_drain(ev: Stream, latency: float) -> Stream:
    """Append the end-of-step event returning occupancy to zero."""
    t, dn, do = ev
    sn, so = int(dn.sum()), int(do.sum())
    if sn == 0 and so == 0:
        return ev
    return (np.append(t, latency), np.append(dn, -sn), np.append(do, -so))


@dataclass
class StepProbe:
    """One exact DES run of the decode-step graph at context length `ctx`."""
    ctx: int
    result: SimResult
    events: Dict[str, Stream]          # raw per-memory streams, DES order
    structural: Dict[str, Stream] = field(default_factory=dict)
    drops: Dict[str, Stream] = field(default_factory=dict)

    @classmethod
    def run(cls, cfg, accel: AcceleratorConfig, ctx: int, *, batch: int,
            subops: int, byte: int, policy: str,
            memoize_layers: bool) -> "StepProbe":
        g = build_decode_graph(cfg, context_len=ctx, batch=batch,
                               subops=subops, byte=byte)
        res = simulate(g, accel, policy=policy,
                       memoize_layers=memoize_layers)
        ev = {m: (np.asarray(tr.ev_times, np.float64),
                  np.asarray(tr.ev_dneeded, np.int64),
                  np.asarray(tr.ev_dobsolete, np.int64))
              for m, tr in res.traces.items()}
        p = cls(ctx, res, ev)
        for m, e in ev.items():
            p.structural[m], p.drops[m] = _split(e)
        return p

    def step_stream(self, m: str) -> Stream:
        """The step's full event stream as it enters the tiled horizon."""
        return _with_drain(self.events[m], self.result.total_time)


@dataclass
class DecodeSimResult:
    """Full decode-horizon Stage-I artifact (Stage-II `TraceSource`).

    `traces`/`access`/`total_time`/`graph_name` satisfy the Stage-II input
    contract, so `core.explorer.sweep` and the gating evaluators run on a
    synthesized horizon unchanged. Per-step views are kept in step-major
    order: `step_events(mem, i)` recovers step i's relative event stream
    bit-exactly for probe steps."""
    graph_name: str
    accel_name: str
    fidelity: str                       # "exact" | "pss" (as executed)
    start_ctx: int
    steps: int
    batch: int
    total_time: float
    traces: Dict[str, OccupancyTrace]
    access: AccessStats
    step_latency: np.ndarray            # (steps,) seconds
    step_offsets: np.ndarray            # (steps,) absolute start offsets
    probes: Tuple[int, ...]             # context lengths simulated exactly
    writebacks: int
    total_macs: int
    total_vector_ops: int
    dram_traffic_bytes: int
    fallback_reason: str = ""           # set when auto fell back to exact
    replayed_layers: int = 0
    # step-major flattened per-step relative event times + counts per memory
    _step_rel: Dict[str, np.ndarray] = field(default_factory=dict, repr=False)
    _step_counts: Dict[str, np.ndarray] = field(default_factory=dict,
                                                repr=False)

    def peak_needed(self, mem: str = "sram") -> int:
        return self.traces[mem].peak_needed()

    def step_ctx(self, i: int) -> int:
        return self.start_ctx + i

    def step_events(self, mem: str, i: int):
        """(rel_times, d_needed, d_obsolete) of step i for one memory."""
        counts = self._step_counts[mem]
        tr = self.traces[mem]
        s = int(counts[:i].sum())
        e = s + int(counts[i])
        return (self._step_rel[mem][s:e],
                np.asarray(tr.ev_dneeded[s:e], np.int64),
                np.asarray(tr.ev_dobsolete[s:e], np.int64))


# ---------------------------------------------------------------------------
# Affinity validation
# ---------------------------------------------------------------------------

def _affine_check(values: np.ndarray, probes: Sequence[int]):
    """values[j] per probe -> (ok, uniform): slopes must be exactly
    integral in every probe bracket; `uniform` adds cross-bracket equality
    (true affinity over the whole span, not just piecewise)."""
    v = np.asarray(values)
    slopes = []
    for j in range(len(probes) - 1):
        span = probes[j + 1] - probes[j]
        diff = v[j + 1] - v[j]
        if np.any(diff % span != 0):
            return False, False
        slopes.append(diff // span)
    uniform = all(np.array_equal(slopes[0], s) for s in slopes[1:])
    return True, uniform


def _validate_probes(probes: List[StepProbe], time_rtol: float
                     ) -> Tuple[bool, str]:
    """The affinity contract that makes PSS synthesis exact-or-boundable."""
    base = probes[0]
    ctxs = [p.ctx for p in probes]
    for p in probes:
        if p.result.writebacks:
            return False, f"write-backs at probe ctx={p.ctx}"
    for m in base.events:
        counts = [len(p.structural[m][0]) for p in probes]
        if len(set(counts)) != 1:
            return False, f"structural event-count mismatch in {m}: {counts}"
        if counts[0] == 0:
            continue
        for comp, name in ((1, "d_needed"), (2, "d_obsolete")):
            ok, uniform = _affine_check(
                np.stack([p.structural[m][comp] for p in probes]), ctxs)
            if not ok:
                return False, f"non-integral {name} slope in {m}"
            if not uniform:
                return False, f"{name} slope kink across brackets in {m}"
        if np.any((np.stack([p.structural[m][1] for p in probes]) == 0)
                  & (np.stack([p.structural[m][2] for p in probes]) == 0)):
            return False, f"degenerate zero event in {m}"
    mems = set()
    for p in probes:
        mems |= set(p.result.access.reads_bytes) | \
            set(p.result.access.writes_bytes)
    for getter, name in (
            (lambda p, m: p.result.access.reads_bytes.get(m, 0), "reads"),
            (lambda p, m: p.result.access.writes_bytes.get(m, 0), "writes")):
        for m in mems:
            ok, uniform = _affine_check(
                np.array([getter(p, m) for p in probes], np.int64), ctxs)
            if not (ok and uniform):
                return False, f"non-affine access {name} in {m}"
    for attr in ("total_macs", "total_vector_ops", "dram_traffic_bytes"):
        ok, uniform = _affine_check(
            np.array([getattr(p.result, attr) for p in probes], np.int64),
            ctxs)
        if not (ok and uniform):
            return False, f"non-affine {attr}"
    # timing: affine up to the refill-chunk kinks; check the prediction of
    # every interior probe from the bracket's outer probes
    if len(probes) >= 3:
        lat = np.array([p.result.total_time for p in probes])
        for j in range(1, len(probes) - 1):
            w = (ctxs[j] - ctxs[0]) / (ctxs[-1] - ctxs[0])
            pred = lat[0] + (lat[-1] - lat[0]) * w
            if abs(pred - lat[j]) > time_rtol * max(lat[j], 1e-12):
                return False, (f"step latency deviates {abs(pred-lat[j]):.3e}s"
                               f" from affine at ctx={ctxs[j]}")
    return True, ""


# ---------------------------------------------------------------------------
# Planning (adaptive probe refinement)
# ---------------------------------------------------------------------------

class _ProbeBudget(Exception):
    pass


def _refine_plan(cfg, accel, cache: Dict[int, StepProbe],
                 probe_ctxs: List[int], kw, time_rtol: float,
                 max_probes: int) -> List[StepProbe]:
    """Bisect non-affine brackets until every consecutive probe pair spans a
    validated affine segment (span-1 brackets are trivially exact). Every
    simulated context becomes a probe boundary of the synthesis plan.
    Raises `_ProbeBudget` when the horizon is too irregular to beat the
    exact path."""

    def get(c: int) -> StepProbe:
        if c not in cache:
            if len(cache) >= max_probes:
                raise _ProbeBudget
            cache[c] = StepProbe.run(cfg, accel, c, **kw)
        return cache[c]

    def refine(lo: int, hi: int) -> None:
        if hi - lo <= 1:
            return
        m = (lo + hi) // 2
        ok, _ = _validate_probes([get(lo), get(m), get(hi)], time_rtol)
        if not ok:
            refine(lo, m)
            refine(m, hi)

    for a, b in zip(probe_ctxs, probe_ctxs[1:]):
        refine(a, b)
    return [cache[c] for c in sorted(cache)]


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def simulate_decode(cfg, accel: AcceleratorConfig, *, start_ctx: int = 1,
                    steps: int = 64, batch: int = 16, subops: int = 4,
                    byte: int = 1, policy: str = "fifo",
                    fidelity: str = "auto", n_probes: int = 3,
                    probes: Optional[Sequence[int]] = None,
                    memoize_layers: bool = False,
                    time_rtol: float = 5e-3,
                    max_probes: Optional[int] = None) -> DecodeSimResult:
    """Simulate a decode phase of `steps` steps starting at context
    `start_ctx` (each step runs the per-step decode graph — the regime of
    the paper's Fig. 1 — back-to-back).

    fidelity:
      * "exact" — step-by-step DES for every context length (O(steps)).
      * "pss"   — probe + synthesize (O(probes)); failing brackets are
                  adaptively bisected; raises ValueError if the probe budget
                  is exhausted before every bracket validates.
      * "auto"  — "pss" when planning succeeds within the probe budget,
                  transparent fallback to "exact" otherwise
                  (`fallback_reason` records why).
    """
    if fidelity not in FIDELITIES:
        raise ValueError(f"fidelity must be one of {FIDELITIES}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    kw = dict(batch=batch, subops=subops, byte=byte, policy=policy,
              memoize_layers=memoize_layers)
    name = f"{cfg.name}@decode[{start_ctx}..{start_ctx + steps - 1}]x{batch}"

    probe_ctxs = (sorted({int(c) for c in probes}) if probes is not None
                  else decode_probe_contexts(start_ctx, steps, n_probes))
    last = start_ctx + steps - 1
    if probes is not None:
        if any(c < start_ctx or c > last for c in probe_ctxs):
            raise ValueError(f"probes {probe_ctxs} outside horizon "
                             f"[{start_ctx}, {last}]")
        probe_ctxs = sorted(set(probe_ctxs) | {start_ctx, last})
    if max_probes is None:
        # refinement must stay well below the exact path's cost
        max_probes = max(16, min(64, steps // 4))

    if fidelity == "exact" or steps <= len(probe_ctxs):
        return _record_decode_sim(
            _simulate_exact(cfg, accel, name, start_ctx, steps, kw), steps, 0)

    cache = {c: StepProbe.run(cfg, accel, c, **kw) for c in probe_ctxs}
    runs = [cache[c] for c in probe_ctxs]
    ok, reason = _validate_probes(runs, time_rtol)
    if not ok:
        try:
            runs = _refine_plan(cfg, accel, cache, probe_ctxs, kw,
                                time_rtol, max_probes)
        except _ProbeBudget:
            reason = (f"probe budget {max_probes} exhausted refining "
                      f"non-affine horizon ({reason})")
            if fidelity == "pss":
                raise ValueError(
                    f"PSS planning failed: {reason}; use fidelity='auto' "
                    f"or 'exact', or raise max_probes")
            res = _simulate_exact(cfg, accel, name, start_ctx, steps, kw)
            res.fallback_reason = reason
            return _record_decode_sim(res, steps, len(cache))
    return _record_decode_sim(
        _synthesize(accel, name, start_ctx, steps, kw["batch"], runs),
        steps, len(runs))


def _record_decode_sim(res: "DecodeSimResult", steps: int,
                       n_probes: int) -> "DecodeSimResult":
    """Fold one simulate_decode outcome into the process-wide registry:
    how often PSS ran, how many probe DES runs it spent, how many steps it
    synthesized vs simulated exactly, and the fallbacks it took."""
    from repro_torch.obs.telemetry import default_registry
    tel = default_registry()
    tel.counter("sim.pss.decode_sims").inc()
    tel.counter("sim.pss.probes").inc(n_probes)
    if n_probes:
        tel.counter("sim.pss.brackets").inc(max(n_probes - 1, 0))
    if res.fallback_reason:
        tel.counter("sim.pss.fallbacks").inc()
    if n_probes and not res.fallback_reason:
        tel.counter("sim.pss.synthesized_steps").inc(steps - n_probes)
    else:
        tel.counter("sim.pss.exact_steps").inc(steps)
    return res


def _simulate_exact(cfg, accel: AcceleratorConfig, name: str, start_ctx: int,
                    steps: int, kw) -> DecodeSimResult:
    access = AccessStats()
    traces: Dict[str, OccupancyTrace] = {}
    rel: Dict[str, List[np.ndarray]] = {}
    counts: Dict[str, List[int]] = {}
    lat = np.zeros(steps)
    offsets = np.zeros(steps)
    wb = macs = vops = dram = 0
    replayed = 0
    t_cursor = 0.0
    for i in range(steps):
        p = StepProbe.run(cfg, accel, start_ctx + i, **kw)
        offsets[i] = t_cursor
        lat[i] = p.result.total_time
        t_cursor += p.result.total_time
        for m in p.events:
            t, dn, do = p.step_stream(m)
            if m not in traces:
                traces[m] = OccupancyTrace(m, p.result.traces[m].capacity)
                rel[m], counts[m] = [], []
            traces[m].extend(t + offsets[i], dn, do)
            rel[m].append(t)
            counts[m].append(len(t))
        for m, b in p.result.access.reads_bytes.items():
            access.add_read(m, b)
        for m, b in p.result.access.writes_bytes.items():
            access.add_write(m, b)
        wb += p.result.writebacks
        macs += p.result.total_macs
        vops += p.result.total_vector_ops
        dram += p.result.dram_traffic_bytes
        replayed += p.result.replayed_layers
    return DecodeSimResult(
        graph_name=name, accel_name=accel.name, fidelity="exact",
        start_ctx=start_ctx, steps=steps, batch=kw["batch"],
        total_time=float(t_cursor), traces=traces, access=access,
        step_latency=lat, step_offsets=offsets,
        probes=tuple(range(start_ctx, start_ctx + steps)),
        writebacks=wb, total_macs=macs, total_vector_ops=vops,
        dram_traffic_bytes=dram, replayed_layers=replayed,
        _step_rel={m: (np.concatenate(v) if v else np.zeros(0))
                   for m, v in rel.items()},
        _step_counts={m: np.asarray(v, np.int64)
                      for m, v in counts.items()})


def _interp_int(v0: np.ndarray, v1: np.ndarray, span: int,
                crel: np.ndarray) -> np.ndarray:
    """Exact integer affine interpolation (validated divisible slopes)."""
    slope = (v1 - v0) // span
    return v0[None, :] + slope[None, :] * crel[:, None]


def _scalar_series(runs: List[StepProbe], getter, ctxs: np.ndarray,
                   bracket: np.ndarray) -> np.ndarray:
    """Per-step integer series from per-probe scalars (piecewise affine)."""
    pv = np.array([getter(p) for p in runs], np.int64)
    pc = np.array([p.ctx for p in runs], np.int64)
    out = np.empty(len(ctxs), np.int64)
    for j in range(len(runs) - 1):
        mask = bracket == j
        if not mask.any():
            continue
        span = int(pc[j + 1] - pc[j])
        out[mask] = pv[j] + (pv[j + 1] - pv[j]) // span * (ctxs[mask] - pc[j])
    return out


def _synthesize(accel: AcceleratorConfig, name: str, start_ctx: int,
                steps: int, batch: int,
                runs: List[StepProbe]) -> DecodeSimResult:
    """Tile the validated probe patterns across the whole horizon.

    Brackets may carry different drop counts (capacity-eviction thresholds
    found by refinement), so per-step streams are assembled bracket-major
    (= step-major, since brackets partition the horizon)."""
    pc = np.array([p.ctx for p in runs], np.int64)
    ctxs = start_ctx + np.arange(steps, dtype=np.int64)
    # bracket[i] = probe interval of step i: [pc[j], pc[j+1]]
    bracket = np.clip(np.searchsorted(pc, ctxs, side="right") - 1,
                      0, len(pc) - 2)
    probe_row = {int(c): j for j, c in enumerate(pc)}

    # per-step latencies (float affine interp), then cumulative offsets
    plat = np.array([p.result.total_time for p in runs])
    lat = np.empty(steps)
    for j in range(len(pc) - 1):
        mask = bracket == j
        if not mask.any():
            continue
        span = float(pc[j + 1] - pc[j])
        w = (ctxs[mask] - pc[j]) / span
        lat[mask] = plat[j] + (plat[j + 1] - plat[j]) * w
    for c, j in probe_row.items():
        lat[c - start_ctx] = plat[j]
    offsets = np.concatenate([[0.0], np.cumsum(lat[:-1])])

    traces: Dict[str, OccupancyTrace] = {}
    step_rel: Dict[str, np.ndarray] = {}
    step_counts: Dict[str, np.ndarray] = {}
    for m in runs[0].events:
        blk_t: List[np.ndarray] = []
        blk_dn: List[np.ndarray] = []
        blk_do: List[np.ndarray] = []
        counts = np.zeros(steps, np.int64)
        for j, run in enumerate(runs):
            t_p, dn_p, do_p = run.step_stream(m)
            counts[run.ctx - start_ctx] = len(t_p)
            blk_t.append(t_p)
            blk_dn.append(dn_p)
            blk_do.append(do_p)
            if j == len(runs) - 1:
                break
            span = int(pc[j + 1] - pc[j])
            if span <= 1:
                continue
            # interior steps of a validated bracket: structural events are
            # exactly affine; drops borrow this probe's pattern (time-scaled
            # to the step latency); the drain keeps each step zero-balanced
            crel = np.arange(1, span, dtype=np.int64)
            n_int = span - 1
            ts, dns, dos = run.structural[m]
            tn, dnn, don = runs[j + 1].structural[m]
            td, dnd, dod = run.drops[m]
            ilat = lat[run.ctx - start_ctx + 1:run.ctx - start_ctx + span]
            parts_t, parts_dn, parts_do = [], [], []
            if len(ts):
                parts_t.append(ts[None, :]
                               + (tn - ts)[None, :] * (crel / span)[:, None])
                parts_dn.append(_interp_int(dns, dnn, span, crel))
                parts_do.append(_interp_int(dos, don, span, crel))
            if len(td):
                scale = ilat / max(plat[j], 1e-30)
                parts_t.append(td[None, :] * scale[:, None])
                parts_dn.append(np.broadcast_to(dnd, (n_int, len(td))))
                parts_do.append(np.broadcast_to(dod, (n_int, len(td))))
            if not parts_t:
                continue
            it = np.concatenate(parts_t, axis=1)
            idn = np.concatenate(parts_dn, axis=1)
            ido = np.concatenate(parts_do, axis=1)
            sn, so = idn.sum(axis=1), ido.sum(axis=1)
            drained = (sn != 0) | (so != 0)
            if drained.any():
                it = np.concatenate([it, ilat[:, None]], axis=1)
                idn = np.concatenate([idn, -sn[:, None]], axis=1)
                ido = np.concatenate([ido, -so[:, None]], axis=1)
            counts[run.ctx - start_ctx + 1:
                   run.ctx - start_ctx + span] = it.shape[1]
            blk_t.append(it.reshape(-1))
            blk_dn.append(idn.reshape(-1))
            blk_do.append(ido.reshape(-1))
        rel = np.concatenate(blk_t) if blk_t else np.zeros(0)
        dn = np.concatenate(blk_dn) if blk_dn else np.zeros(0, np.int64)
        do = np.concatenate(blk_do) if blk_do else np.zeros(0, np.int64)
        tr = OccupancyTrace(m, runs[0].result.traces[m].capacity)
        tr.extend(rel + np.repeat(offsets, counts), dn, do)
        assert tr.n_events == int(counts.sum()), \
            "degenerate synthesized event dropped (validation gap)"
        traces[m] = tr
        step_rel[m] = rel
        step_counts[m] = counts

    access = AccessStats()
    mems = set()
    for p in runs:
        mems |= set(p.result.access.reads_bytes) | \
            set(p.result.access.writes_bytes)
    for m in sorted(mems):
        r = _scalar_series(
            runs, lambda p: p.result.access.reads_bytes.get(m, 0),
            ctxs, bracket)
        w = _scalar_series(
            runs, lambda p: p.result.access.writes_bytes.get(m, 0),
            ctxs, bracket)
        if r.sum():
            access.add_read(m, int(r.sum()))
        if w.sum():
            access.add_write(m, int(w.sum()))

    totals = {attr: int(_scalar_series(
        runs, lambda p, a=attr: getattr(p.result, a), ctxs, bracket).sum())
        for attr in ("total_macs", "total_vector_ops", "dram_traffic_bytes")}

    return DecodeSimResult(
        graph_name=name, accel_name=accel.name, fidelity="pss",
        start_ctx=start_ctx, steps=steps, batch=batch,
        total_time=float(offsets[-1] + lat[-1]), traces=traces,
        access=access, step_latency=lat, step_offsets=offsets,
        probes=tuple(int(c) for c in pc),
        writebacks=sum(p.result.writebacks for p in runs),
        total_macs=totals["total_macs"],
        total_vector_ops=totals["total_vector_ops"],
        dram_traffic_bytes=totals["dram_traffic_bytes"],
        replayed_layers=sum(p.result.replayed_layers for p in runs),
        _step_rel=step_rel, _step_counts=step_counts)


# ---------------------------------------------------------------------------
# Causal affine extrapolation (the forecast leg of the online controller)
# ---------------------------------------------------------------------------

class AffineForecaster:
    """Causal trailing-window affine extrapolator over an irregular series.

    The PSS machinery above exploits that Stage-I decode is affine in
    context length; this is the same trick pointed at *time*: inside a
    traffic ramp the occupancy series is locally affine, so a least-squares
    line over the trailing `window_s` of samples extrapolates the demand a
    gating controller is about to see. All window sums come from prefix
    sums, so a query costs O(log n) (two searchsorted calls); the fit is
    re-centered on the window's first sample to keep the normal equations
    well-conditioned at large absolute times.

    Strictly causal: a query at time `t` only sees samples with
    ``time <= t``.
    """

    def __init__(self, times: np.ndarray, values: np.ndarray,
                 window_s: float):
        t = np.asarray(times, np.float64)
        y = np.asarray(values, np.float64)
        if t.ndim != 1 or t.shape != y.shape:
            raise ValueError("times/values must be equal-length 1-D arrays")
        if len(t) > 1 and np.any(np.diff(t) < 0):
            raise ValueError("times must be non-decreasing")
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        self.window_s = float(window_s)
        self._t = t
        self._y = y
        z = np.zeros(1)
        self._ct = np.concatenate([z, np.cumsum(t)])
        self._cy = np.concatenate([z, np.cumsum(y)])
        self._ctt = np.concatenate([z, np.cumsum(t * t)])
        self._cty = np.concatenate([z, np.cumsum(t * y)])

    def _window(self, now_s: float) -> Tuple[int, int]:
        hi = int(np.searchsorted(self._t, now_s, side="right"))
        lo = int(np.searchsorted(self._t, now_s - self.window_s,
                                 side="left"))
        return lo, hi

    def fit(self, now_s: float) -> Tuple[float, float]:
        """(intercept-at-now, slope) of the trailing-window least-squares
        line. Empty window → (0, 0); degenerate (single sample or zero
        time spread) → (window mean, 0)."""
        lo, hi = self._window(now_s)
        n = hi - lo
        if n == 0:
            # nothing in the window: hold the last value seen before it
            return (float(self._y[hi - 1]), 0.0) if hi else (0.0, 0.0)
        sy = self._cy[hi] - self._cy[lo]
        if n == 1:
            return float(sy), 0.0
        c = float(self._t[lo])            # re-center for conditioning
        st = self._ct[hi] - self._ct[lo] - n * c
        stt = (self._ctt[hi] - self._ctt[lo]
               - 2.0 * c * (self._ct[hi] - self._ct[lo]) + n * c * c)
        sty = self._cty[hi] - self._cty[lo] - c * sy
        det = n * stt - st * st
        if det <= 0 or not np.isfinite(det):
            return float(sy / n), 0.0
        b = (n * sty - st * sy) / det
        a = (sy - b * st) / n             # intercept at t = c
        return float(a + b * (now_s - c)), float(b)

    def slope(self, now_s: float) -> float:
        return self.fit(now_s)[1]

    def forecast(self, now_s: float, horizon_s: float) -> float:
        """Extrapolated value at ``now_s + horizon_s`` (clamped at 0 —
        occupancies cannot go negative)."""
        v, b = self.fit(now_s)
        return max(0.0, v + b * horizon_s)


def affine_forecast(times: np.ndarray, values: np.ndarray, now_s: float,
                    horizon_s: float, window_s: float) -> float:
    """One-shot convenience wrapper over :class:`AffineForecaster`."""
    return AffineForecaster(times, values, window_s).forecast(
        now_s, horizon_s)
