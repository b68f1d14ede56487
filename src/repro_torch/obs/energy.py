"""Streaming per-bank energy meter with per-request/per-tenant attribution;
a copy of the reference package's `repro/obs/energy.py`.

Stage II (`core.gating.evaluate`) replays finished traces offline; the
:class:`BankEnergyMeter` turns the same Eq. (2)-(5) energy model into a
*live* observable. It subscribes to the very delta events the occupancy
traces are built from (page alloc/free/COW/truncate in the serving ledgers,
`trace.event` in the model-free traffic sims) and maintains, online on the
sim clock, a per-bank state machine — active / drowsy / gated, wake
transients, stall windows — for one ``(C, B, alpha, policy)`` candidate.

Exactness contract: every event is mirrored into an internal
`OccupancyTrace`, and :meth:`finalize` runs the *offline scalar reference*
over the mirrored stream through the identical assembly pipeline
(stable time sort -> integrate -> collapse duplicate timestamps ->
segment). The meter's cumulative energy is therefore **bit-identical
(f64)** to `gating.evaluate` on the same trace — pinned across all four
policies by ``tests/test_energy_attribution.py``. The online machine is
additionally pinned structurally: its per-segment activity equals
`gating.bank_timeline`'s exactly, its transition count equals the
reference's ``n_transitions`` exactly, and its sequentially-accumulated
energy agrees with the reference to float roundoff (the reference's
pairwise numpy reductions are the only difference).

Attribution: every accounted joule is charged either to the request (and
tenant) whose tagged page events caused or sustained it — switch energy to
the request whose event woke the bank, retention pro rata over the bytes
each live request holds — or to an explicit *floor* (idle-bank leakage,
unattributed/cache retention, short-idle retention, trailing transitions).
Conservation, monotone non-negative charges and arrival-permutation
invariance are property-tested.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.cacti import (WAKEUP_LATENCY_NS, SramCharacterization,
                              characterize)
from repro_torch.core.gating import GatingResult, Policy, evaluate
from repro_torch.sim.trace import OccupancyTrace

WAKE_CAUSES = ("admission", "decode_growth", "cow", "spec_rollback",
               "prewake", "other")

# bank states reported on intervals / Perfetto tracks
STATE_ACTIVE = "active"
STATE_IDLE = "idle"          # short idle, bank kept fully powered
STATE_DROWSY = "drowsy"      # short idle at retention voltage
STATE_GATED = "gated"


class _OutOfOrder(Exception):
    pass


class _Machine:
    """Online per-bank state machine over closed occupancy segments.

    Mirrors `gating.evaluate`'s arithmetic wherever a sequential form
    exists bit-for-bit: segment durations are direct subtractions
    (== np.diff), the duration prefix sum is sequential (== np.cumsum), so
    per-run idle durations and every gate/no-gate threshold decision are
    exact. Only the grand totals differ from the reference's pairwise
    reductions, and only in the last ulps."""

    def __init__(self, capacity: int, banks: int, policy: Policy,
                 char: SramCharacterization, use: str, keep_series: bool):
        self.capacity, self.B = capacity, banks
        self.policy, self.ch, self.use = policy, char, use
        self.keep_series = keep_series
        self.usable = policy.alpha * (capacity / banks)
        self.threshold = policy.min_gate_multiple * char.break_even_s
        self.leak_w = char.leak_w_per_bank
        self.e_switch = char.e_switch_j
        self.wake_s = WAKEUP_LATENCY_NS * 1e-9
        self.drowsy = (policy.drowsy_fraction != 1.0
                       or policy.drowsy_switch_fraction != 0.0)
        # integrated occupancy
        self.needed = 0
        self.obsolete = 0
        # open segment / group state; the "group" is all events sharing the
        # open segment's start timestamp (the trace collapses them into one
        # step), and the wake attribution winner is chosen by an
        # order-independent key so delivery permutations cannot flip it
        self.t0: Optional[float] = None
        self.group_rid = None
        self.group_tenant = None
        self.group_cause: Optional[str] = None
        self.group_key: Optional[Tuple] = None
        self.group_ckey: Optional[Tuple] = None
        # sequential prefix sum of closed segment durations (== np.cumsum)
        self.cum_d = 0.0
        self.nseg = 0
        self.prev_act = banks                # "all on" before the timeline
        self.bank_on_since = [math.nan] * banks
        self.idle_start_cum: List[Optional[float]] = [None] * banks
        self.idle_start_t = [math.nan] * banks
        # accumulators (sequential f64)
        self.e_leak = 0.0
        self.e_sw = 0.0
        self.on_bank_s = 0.0                 # required (active) bank-seconds
        self.gated_s = 0.0
        self.drowsy_s = 0.0
        self.n_sw = 0
        self.n_drowsy = 0
        self.stall_s = 0.0
        self.wakes: Dict[str, int] = {}
        # attribution
        self.held: Dict[object, float] = {}          # rid -> live bytes
        self.req_j: Dict[object, float] = {}
        self.tenant_j: Dict[str, float] = {}
        self.rid_tenant: Dict[object, str] = {}
        self.floor_j = 0.0
        # series + intervals for dashboards / Perfetto export
        self.seg_t0: List[float] = []
        self.seg_dur: List[float] = []
        self.seg_act: List[int] = []
        self.seg_cum_j: List[float] = []
        self.intervals: List[Tuple[int, str, float, float]] = []

    # ----------------------------------------------------------- charging
    def _charge(self, j: float, rid, cause: Optional[str]) -> None:
        if j == 0.0:
            return
        if rid is None:
            self.floor_j += j
            return
        self.req_j[rid] = self.req_j.get(rid, 0.0) + j
        ten = self.rid_tenant.get(rid)
        if ten is not None:
            self.tenant_j[ten] = self.tenant_j.get(ten, 0.0) + j

    def _activity(self) -> int:
        occ = (self.needed if self.use == "needed"
               else self.needed + self.obsolete)
        v = np.ceil(np.float64(occ) / self.usable)
        return int(min(max(v, 0.0), float(self.B)))

    def _resolve_idle_run(self, b: int, run_d: float, t_end: float,
                          wake: bool) -> None:
        """An idle run of bank `b` closed (a wake at `t_end`, or the
        timeline flushed). Gate/drowsy decision + charging, matching the
        reference's per-run arithmetic."""
        start_t = self.idle_start_t[b]
        self.idle_start_cum[b] = None
        if run_d >= self.threshold:
            self.n_sw += 1
            self.gated_s += run_d
            self.e_sw += self.e_switch
            state = STATE_GATED
            if wake:
                cause = self.group_cause or "other"
                self.wakes[cause] = self.wakes.get(cause, 0) + 1
                self.stall_s += self.wake_s
                self._charge(self.e_switch, self.group_rid, cause)
            else:
                self.floor_j += self.e_switch
        elif self.drowsy:
            self.n_drowsy += 1
            self.drowsy_s += run_d
            retain = self.policy.drowsy_fraction * self.leak_w * run_d
            sw = self.e_switch * self.policy.drowsy_switch_fraction
            self.e_leak += retain
            self.e_sw += sw
            self.floor_j += retain            # retained data serves everyone
            state = STATE_DROWSY
            if wake:
                cause = self.group_cause or "other"
                self.wakes[cause] = self.wakes.get(cause, 0) + 1
                self._charge(sw, self.group_rid, cause)
            else:
                self.floor_j += sw
        else:
            # classic two-state: too short to gate, bank stayed fully on
            leak = self.leak_w * run_d
            self.e_leak += leak
            self.floor_j += leak
            state = STATE_IDLE
        if self.keep_series and not math.isnan(start_t):
            self.intervals.append((b, state, start_t, t_end))
        self.bank_on_since[b] = t_end

    def _close_segment(self, t: float) -> None:
        """Close the open segment [t0, t); occupancy state already holds
        every event at t0 and nothing later."""
        t0 = self.t0
        dur = t - t0
        if dur <= 0.0:
            return
        act = self._activity()
        cum0 = self.cum_d                    # == cum[i] before this segment
        if self.policy.gate:
            if act > self.prev_act:          # banks woke at t0
                for b in range(self.prev_act, act):
                    if self.idle_start_cum[b] is not None:
                        run_d = cum0 - self.idle_start_cum[b]
                        self._resolve_idle_run(b, run_d, t0, wake=True)
                    else:
                        self.bank_on_since[b] = t0
            elif act < self.prev_act:        # banks went idle at t0
                for b in range(act, self.prev_act):
                    self.idle_start_cum[b] = cum0
                    self.idle_start_t[b] = t0
                    if self.keep_series and not math.isnan(
                            self.bank_on_since[b]):
                        self.intervals.append(
                            (b, STATE_ACTIVE, self.bank_on_since[b], t0))
        # retention of the banks the occupancy requires, split pro rata
        # over the bytes each live request holds
        e_on = self.leak_w * act * dur
        self.e_leak += (e_on if self.policy.gate
                        else self.leak_w * self.B * dur)
        if not self.policy.gate:
            self.floor_j += self.leak_w * (self.B - act) * dur
        if e_on > 0.0:
            W = 0.0
            for h in self.held.values():
                if h > 0.0:
                    W += h
            if W > 0.0:
                for rid, h in self.held.items():
                    if h > 0.0:
                        self._charge(e_on * (h / W), rid, None)
            else:
                self.floor_j += e_on
        self.on_bank_s += act * dur
        self.cum_d += dur
        self.nseg += 1
        self.prev_act = act
        if self.keep_series:
            self.seg_t0.append(t0)
            self.seg_dur.append(dur)
            self.seg_act.append(act)
            self.seg_cum_j.append(self.e_leak + self.e_sw)

    # ------------------------------------------------------------ ingest
    def push(self, t: float, dn: int, do: int, rid, tenant,
             cause: Optional[str], wdelta: Optional[int]) -> None:
        w = dn if wdelta is None else wdelta
        if dn == 0 and do == 0:
            # pure holdings update — never a step-function boundary (the
            # trace drops it), so it must not split a segment; a stale one
            # still forces the replay path so holdings land in time order
            if self.t0 is not None and t < self.t0:
                raise _OutOfOrder
            if rid is not None:
                if tenant is not None:
                    self.rid_tenant[rid] = tenant
                if w:
                    self.held[rid] = self.held.get(rid, 0.0) + w
            return
        if self.t0 is None:
            self.t0 = t
        elif t > self.t0:
            self._close_segment(t)
            self.t0 = t
            self.group_rid = self.group_tenant = self.group_cause = None
            self.group_key = self.group_ckey = None
        elif t < self.t0:
            raise _OutOfOrder
        self.needed += dn
        self.obsolete += do
        if rid is not None:
            if tenant is not None:
                self.rid_tenant[rid] = tenant
            if w:
                self.held[rid] = self.held.get(rid, 0.0) + w
        if dn > 0:
            if rid is not None:
                key = (dn, str(rid))
                if self.group_key is None or key > self.group_key:
                    self.group_key = key
                    self.group_rid, self.group_tenant = rid, tenant
            if cause is not None:
                ckey = (dn, cause)
                if self.group_ckey is None or ckey > self.group_ckey:
                    self.group_ckey = ckey
                    self.group_cause = cause

    def flush(self, end_time: float) -> None:
        """Close the final segment against `end_time` and resolve trailing
        idle runs — mirrors `segments()`'s trailing edge and the
        reference's runs that end at the last segment."""
        if self.t0 is not None:
            self._close_segment(max(end_time, self.t0))
            self.t0 = None
        if self.policy.gate:
            for b in range(self.B):
                if self.idle_start_cum[b] is not None:
                    run_d = self.cum_d - self.idle_start_cum[b]
                    self._resolve_idle_run(b, run_d, float("nan"), wake=False)
                elif self.keep_series and not math.isnan(
                        self.bank_on_since[b]):
                    self.intervals.append(
                        (b, STATE_ACTIVE, self.bank_on_since[b],
                         max(end_time, self.bank_on_since[b])))
        elif self.keep_series and self.seg_t0:
            for b in range(self.B):
                self.intervals.append(
                    (b, STATE_ACTIVE, self.seg_t0[0],
                     max(end_time, self.seg_t0[0])))
        # intervals whose run closed at flush have a NaN end: pin them
        if self.keep_series:
            self.intervals = [
                (b, st, a, (max(end_time, a) if math.isnan(e) else e))
                for (b, st, a, e) in self.intervals]


@dataclass
class MeterReport:
    """Headline view of one metered run — campaign rows and the obs CLI."""
    result: GatingResult                     # exact (bit-identical) Stage II
    live_e_j: float                          # online accumulation (no e_dyn)
    request_j: Dict[object, float]
    tenant_j: Dict[str, float]
    floor_j: float
    wakes: Dict[str, int]
    stall_s: float
    j_per_request: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # p50/90/99
    j_per_token: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def format(self) -> str:
        r = self.result
        lines = [
            f"bank energy meter  C={r.capacity / 2**20:g} MiB B={r.banks} "
            f"alpha={r.alpha:g} policy={r.policy}",
            f"  E_total={r.e_total * 1e3:.4g} mJ  (dyn {r.e_dyn * 1e3:.4g}, "
            f"leak {r.e_leak * 1e3:.4g}, sw {r.e_sw * 1e3:.4g})  "
            f"transitions={r.n_transitions}  stall={self.stall_s * 1e3:.3g} ms",
        ]
        if self.wakes:
            ws = ", ".join(f"{c}={n}" for c, n in sorted(self.wakes.items()))
            lines.append(f"  wakes: {ws}")
        if self.request_j:
            p50, p90, p99 = self.j_per_request
            lines.append(f"  J/request p50={p50:.3e} p90={p90:.3e} "
                         f"p99={p99:.3e}  attributed "
                         f"{sum(self.request_j.values()) * 1e3:.4g} mJ, "
                         f"floor {self.floor_j * 1e3:.4g} mJ")
        if any(self.j_per_token):
            p50, p90, p99 = self.j_per_token
            lines.append(f"  J/token   p50={p50:.3e} p90={p90:.3e} "
                         f"p99={p99:.3e}")
        for ten, j in sorted(self.tenant_j.items(),
                             key=lambda kv: -kv[1])[:8]:
            lines.append(f"    tenant {ten}: {j * 1e3:.4g} mJ")
        return "\n".join(lines)


class BankEnergyMeter:
    """Online Stage-II energy for one ``(C, B, alpha, policy)`` candidate.

    Feed it the same (t, d_needed, d_obsolete) delta events the occupancy
    trace receives — tagged with the causing request/tenant — via
    :meth:`record`; query live state any time; :meth:`finalize` returns the
    bit-identical offline `GatingResult`."""

    def __init__(self, capacity: int, banks: int, *,
                 policy: Union[Policy, str] = "conservative",
                 alpha: Optional[float] = None,
                 char: Optional[SramCharacterization] = None,
                 use: str = "needed", telemetry=None,
                 keep_series: bool = True):
        if use not in ("needed", "total"):
            raise ValueError(f"use must be needed|total, got {use!r}")
        if isinstance(policy, str):
            policy = Policy.by_name(policy, alpha)
        elif alpha is not None and alpha != policy.alpha:
            from dataclasses import replace
            policy = replace(policy, alpha=alpha)
        self.capacity = int(capacity)
        self.banks = int(banks)
        self.policy = policy
        self.char = char or characterize(self.capacity, self.banks)
        self.use = use
        self.tel = telemetry
        self.keep_series = keep_series
        # the exactness substrate: a verbatim mirror of the event stream
        self.trace = OccupancyTrace("meter", self.capacity)
        # parallel log (incl. zero-delta holdings updates) for replay
        self._t: List[float] = []
        self._dn: List[int] = []
        self._do: List[int] = []
        self._tags: List[Tuple] = []
        self._m = self._fresh_machine()
        self._dirty = False
        self._last_t = 0.0
        self._prewakes = 0
        self._published: Dict[str, int] = {}
        self.n_events = 0

    @classmethod
    def from_spec(cls, spec: str, *, telemetry=None,
                  keep_series: bool = True) -> "BankEnergyMeter":
        """Parse a CLI meter spec ``C_mib,B[,alpha[,policy]]`` — e.g.
        ``64,8,0.9,conservative`` — into a configured meter."""
        parts = [p.strip() for p in str(spec).split(",")]
        if len(parts) < 2 or len(parts) > 4:
            raise ValueError(
                f"meter spec must be 'C_mib,B[,alpha[,policy]]', got {spec!r}")
        cap = int(round(float(parts[0]) * 2**20))
        banks = int(parts[1])
        alpha = float(parts[2]) if len(parts) >= 3 else None
        policy = parts[3] if len(parts) == 4 else "conservative"
        return cls(cap, banks, policy=policy, alpha=alpha,
                   telemetry=telemetry, keep_series=keep_series)

    # ------------------------------------------------------------- ingest
    def _fresh_machine(self) -> _Machine:
        return _Machine(self.capacity, self.banks, self.policy, self.char,
                        self.use, self.keep_series)

    def record(self, t: float, d_needed: int, d_obsolete: int = 0, *,
               rid=None, tenant: Optional[str] = None,
               cause: Optional[str] = None,
               weight_delta: Optional[int] = None) -> None:
        """One ledger delta event: `d_needed`/`d_obsolete` mirror the trace
        deltas; `weight_delta` overrides the attribution-holdings change
        when it differs from `d_needed` (shared/COW pages)."""
        t = float(t)
        dn, do = int(d_needed), int(d_obsolete)
        self._t.append(t)
        self._dn.append(dn)
        self._do.append(do)
        self._tags.append((rid, tenant, cause, weight_delta))
        self.trace.event(t, dn, do)
        self.n_events += 1
        if t > self._last_t:
            self._last_t = t
        if not self._dirty:
            try:
                self._m.push(t, dn, do, rid, tenant, cause, weight_delta)
            except _OutOfOrder:
                self._dirty = True

    def record_bulk(self, times, d_needed, d_obsolete, *,
                    rids: Optional[Sequence] = None,
                    tenants: Optional[Sequence] = None,
                    cause: Optional[str] = None) -> None:
        """Vectorized-source mirror (the traffic sims' `trace.extend`
        path); event order is preserved element-wise."""
        times = np.asarray(times, np.float64)
        dns = np.asarray(d_needed, np.int64)
        dos = np.asarray(d_obsolete, np.int64)
        for i in range(len(times)):
            self.record(float(times[i]), int(dns[i]), int(dos[i]),
                        rid=None if rids is None else rids[i],
                        tenant=None if tenants is None else tenants[i],
                        cause=cause)

    def note_prewake(self, n: int = 1) -> None:
        """A controller pre-wake happened (forecast leg): counted in the
        wake-cause family without perturbing the exact energy integral."""
        self._prewakes += int(n)

    # ----------------------------------------------------------- queries
    def _machine(self) -> _Machine:
        if self._dirty:
            m = self._fresh_machine()
            order = np.argsort(np.asarray(self._t, np.float64),
                               kind="stable")
            for i in order:
                m.push(self._t[i], self._dn[i], self._do[i], *self._tags[i])
            self._m = m
            self._dirty = False
        return self._m

    def _flushed(self, end_time: Optional[float]) -> _Machine:
        end = self._last_t if end_time is None else float(end_time)
        m = copy.deepcopy(self._machine())
        m.flush(end)
        return m

    def finalize(self, end_time: Optional[float] = None, *,
                 n_reads: int = 0, n_writes: int = 0) -> GatingResult:
        """The exact Stage-II result of the streamed trace: assembled by
        the identical `OccupancyTrace` pipeline and evaluated by the
        offline scalar reference — bit-identical f64 to `gating.evaluate`
        on the source trace."""
        end = self._last_t if end_time is None else float(end_time)
        dur, occ = self.trace.occupancy_series(end, use=self.use)
        res = evaluate(dur, occ, capacity=self.capacity, banks=self.banks,
                       policy=self.policy, n_reads=n_reads,
                       n_writes=n_writes, char=self.char)
        self._publish_counters()
        return res

    def energy_j(self, end_time: Optional[float] = None) -> float:
        """Live (sequentially accumulated) leakage + switching energy."""
        m = self._flushed(end_time)
        return m.e_leak + m.e_sw

    def request_energy_j(self, end_time: Optional[float] = None
                         ) -> Dict[object, float]:
        return dict(self._flushed(end_time).req_j)

    def request_energy(self, rid, end_time: Optional[float] = None) -> float:
        return self._flushed(end_time).req_j.get(rid, 0.0)

    def request_energy_live(self, rid) -> float:
        """O(1) unflushed charge — no copy, no trailing-run resolution.
        Exact-final for a request whose pages are all freed (its last
        retention charge landed when its free event closed the prior
        segment, and freed requests cause no further wakes)."""
        return self._machine().req_j.get(rid, 0.0)

    def tenant_energy_j(self, end_time: Optional[float] = None
                        ) -> Dict[str, float]:
        return dict(self._flushed(end_time).tenant_j)

    def floor_j(self, end_time: Optional[float] = None) -> float:
        return self._flushed(end_time).floor_j

    def wake_counts(self, end_time: Optional[float] = None) -> Dict[str, int]:
        w = dict(self._flushed(end_time).wakes)
        if self._prewakes:
            w["prewake"] = w.get("prewake", 0) + self._prewakes
        return w

    def stall_s(self, end_time: Optional[float] = None) -> float:
        return self._flushed(end_time).stall_s

    def activity_series(self, end_time: Optional[float] = None):
        """(t0, durations, active_banks) per segment — `active_banks`
        equals `gating.bank_timeline`'s integer activity exactly."""
        m = self._flushed(end_time)
        return (np.asarray(m.seg_t0), np.asarray(m.seg_dur),
                np.asarray(m.seg_act, np.int64))

    def energy_series(self, end_time: Optional[float] = None):
        """(boundary times, cumulative live J) — segment right edges. The
        last point carries the flushed grand total, so trailing idle-run
        charges (resolved only at flush) are never lost by an export."""
        m = self._flushed(end_time)
        edges = np.asarray(m.seg_t0) + np.asarray(m.seg_dur)
        cum = np.asarray(m.seg_cum_j)
        total = m.e_leak + m.e_sw
        if len(edges) and total != cum[-1]:
            edges = np.append(edges, edges[-1])
            cum = np.append(cum, total)
        return edges, cum

    def bank_intervals(self, end_time: Optional[float] = None
                       ) -> List[Tuple[int, str, float, float]]:
        """(bank, state, t_start, t_end) rows, states active|idle|drowsy|
        gated — the Perfetto bank-state timeline."""
        return list(self._flushed(end_time).intervals)

    def report(self, end_time: Optional[float] = None, *,
               n_reads: int = 0, n_writes: int = 0,
               tokens_by_rid: Optional[Dict] = None) -> MeterReport:
        m = self._flushed(end_time)
        res = self.finalize(end_time, n_reads=n_reads, n_writes=n_writes)
        req = dict(m.req_j)
        rep = MeterReport(result=res, live_e_j=m.e_leak + m.e_sw,
                          request_j=req, tenant_j=dict(m.tenant_j),
                          floor_j=m.floor_j,
                          wakes=self.wake_counts(end_time),
                          stall_s=m.stall_s)
        if req:
            js = np.asarray(sorted(req.values()))
            rep.j_per_request = tuple(
                float(np.percentile(js, q)) for q in (50, 90, 99))
            if tokens_by_rid:
                per_tok = [j / max(tokens_by_rid.get(rid, 1), 1)
                           for rid, j in req.items()]
                rep.j_per_token = tuple(
                    float(np.percentile(per_tok, q)) for q in (50, 90, 99))
        return rep

    def format_dashboard(self, end_time: Optional[float] = None) -> str:
        """Live one-glance view: occupancy bar, bank states, energy."""
        m = self._flushed(end_time)
        occ = m.needed if self.use == "needed" else m.needed + m.obsolete
        act = m.prev_act if m.nseg else 0
        bar = "#" * act + "-" * (self.banks - act)
        end = self._last_t if end_time is None else end_time
        lines = [
            f"[energy] t={end:.4f}s  occ={occ / 2**20:.2f} MiB  "
            f"banks [{bar}] {act}/{self.banks}  "
            f"policy={self.policy.name} alpha={self.policy.alpha:g}",
            f"  E(live)={(m.e_leak + m.e_sw) * 1e3:.4g} mJ  "
            f"(leak {m.e_leak * 1e3:.4g}, sw {m.e_sw * 1e3:.4g})  "
            f"transitions={m.n_sw}  gated={m.gated_s:.3g} bank-s  "
            f"stall={m.stall_s * 1e3:.3g} ms",
        ]
        w = self.wake_counts(end_time)
        if w:
            lines.append("  wakes: " + ", ".join(
                f"{c}={n}" for c, n in sorted(w.items())))
        if m.tenant_j:
            tot = sum(m.tenant_j.values())
            tops = sorted(m.tenant_j.items(), key=lambda kv: -kv[1])[:4]
            lines.append("  tenants: " + ", ".join(
                f"{t}={j * 1e3:.3g}mJ({j / tot:.0%})" for t, j in tops))
        return "\n".join(lines)

    # --------------------------------------------------------- telemetry
    def _publish_counters(self) -> None:
        if self.tel is None or not getattr(self.tel, "enabled", False):
            return
        for cause, n in self.wake_counts().items():
            prev = self._published.get(cause, 0)
            if n > prev:
                self.tel.counter(f"energy.wakes.{cause}").inc(n - prev)
                self._published[cause] = n
