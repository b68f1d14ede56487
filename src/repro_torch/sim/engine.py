"""Discrete-event, cycle-level simulator (TRAPTI Stage I); a copy of the
reference package's `repro/sim/engine.py`. It is host code by nature: its
event loop and float arithmetic are the reference's, so its traces equal
the reference's bit for bit; each run folds its counters (`sim.des.*`)
into the port's process-wide telemetry registry, as the reference's does.

List-scheduling DES over the workload graph on the accelerator template:

  * ops become ready when every producer has completed;
  * each op runs on one systolic array (matmuls: tiled 128x128 MXU-style time
    model; vector ops: per-array vector unit);
  * every operand is staged in the array's attached on-chip memory — misses
    are fetched from DRAM (or a peer memory in multi-level hierarchies) over
    shared, serialized bandwidth servers (this is where memory-induced stalls
    and port contention come from);
  * the memory manager tracks each tensor as needed/obsolete, evicts LRU
    (obsolete first, matching the paper's policy), and counts capacity-induced
    write-backs of needed tensors;
  * every allocation/transition is recorded into the time-resolved occupancy
    trace — the central Stage-I artifact.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.workload import WorkloadGraph
from repro_torch.sim.accelerator import AcceleratorConfig, MemConfig
from repro_torch.sim.trace import AccessStats, OccupancyTrace, OpStats

REFILL_BYTES = 32 * 1024       # FIFO refill granularity for latency charging

# Replayed layers shift template-relative times to a new absolute base, so
# memoized timestamps agree with the step-by-step DES only up to float
# translation error (~ulp of the absolute time). Entry-state comparisons use
# the same scale-aware tolerance.
MEMO_REL_TOL = 1e-9


def _close(a: float, b: float, scale: float) -> bool:
    return abs(a - b) <= MEMO_REL_TOL * max(1.0, abs(scale))


class _LayerStructure:
    """Per-layer structural view of the graph for the memoization fast path.

    `cohort` is every tensor that *belongs* to the layer (produced by one of
    its ops, or DRAM-resident with all consumers inside the layer — weights,
    KV caches); `ext` is every boundary tensor (the residual stream from the
    previous layer, shared encoder memory, ...). Two layers whose `sig`
    tuples are equal are isomorphic: op i of one maps to op i of the other,
    cohort/ext entry j to entry j."""

    def __init__(self, g: WorkloadGraph, layer: int, oids: List[int]):
        self.layer = layer
        self.oids = oids
        self.cohort: List[int] = []
        self.ext: List[int] = []
        cohort_idx: Dict[int, int] = {}
        ext_idx: Dict[int, int] = {}
        self.cohort_pos = cohort_idx
        self.ext_pos = ext_idx
        oid_set = set(oids)

        def ref(tid: int) -> Tuple[str, int]:
            t = g.tensors[tid]
            if tid in cohort_idx:
                return ("c", cohort_idx[tid])
            if tid in ext_idx:
                return ("e", ext_idx[tid])
            local = (t.producer in oid_set
                     or (t.producer is None
                         and all(c in oid_set for c in t.consumers)))
            if local:
                cohort_idx[tid] = len(self.cohort)
                self.cohort.append(tid)
                return ("c", cohort_idx[tid])
            ext_idx[tid] = len(self.ext)
            self.ext.append(tid)
            return ("e", ext_idx[tid])

        sig = []
        for oid in oids:
            op = g.ops[oid]
            ins = tuple(ref(t) + (g.tensors[t].size, g.tensors[t].kind)
                        for t in op.inputs)
            out = g.tensors[op.output]
            sig.append((op.op_type, op.tag, op.macs, op.vector_ops, op.mnk,
                        ins, ref(op.output) + (out.size, out.kind,
                                               len(out.consumers))))
        self.sig: Tuple = tuple(sig)


class _LayerRecord:
    """Everything one cleanly-simulated layer mutates, relative to its start
    time t0 — enough to replay an isomorphic layer by pure translation."""

    def __init__(self, layer: int, t0: float):
        self.layer = layer
        self.t0 = t0
        self.valid = True
        self.ops_done = 0
        # entry conditions
        self.heap_pat: List[Tuple[float, int]] = []
        self.needed_entry: Dict[str, int] = {}
        self.port_entry: Dict[str, Tuple[float, ...]] = {}
        self.ext_state: List[Tuple] = []
        self.max_used_delta: Dict[str, int] = {}
        # capacity evictions recorded during the layer (timing-free drops of
        # obsolete / elsewhere-copied tensors). When present, replay demands
        # the full LRU profile of every memory to match at entry, so the
        # eviction decisions provably repeat; write-backs (which cost
        # transfer time) always invalidate the record.
        self.had_drops = False
        self.entry_profile: Dict[str, List[Tuple]] = {}
        self.res_drop: Dict[str, List[Tuple]] = {}
        self.dropped: Dict[str, set] = {}
        # entry snapshots (dropped at finalize)
        self.ev_start: Dict[str, int] = {}
        self.reads0: Dict[str, int] = {}
        self.writes0: Dict[str, int] = {}
        self.busy0: Dict[str, float] = {}
        self.used0: Dict[str, int] = {}
        self.resident0: Dict[str, Dict[int, int]] = {}
        self.touch0: Dict[str, Dict[int, float]] = {}
        self.needed0: Dict[str, int] = {}
        self.obsolete0: Dict[str, int] = {}
        self.unit_busy0: Dict[int, float] = {}
        self.opstats0: Tuple = ()
        self.macs0 = 0
        self.vops0 = 0
        self.dram0 = 0
        # recorded deltas (filled at finalize)
        self.events: Dict[str, Tuple[np.ndarray, List[int], List[int]]] = {}
        self.read_d: Dict[str, int] = {}
        self.write_d: Dict[str, int] = {}
        self.bw_busy_d: Dict[str, float] = {}
        self.ports_exit: Dict[str, List[float]] = {}
        self.units_exit: List[float] = []
        self.unit_busy_d: Dict[int, float] = {}
        self.needed_d: Dict[str, int] = {}
        self.obsolete_d: Dict[str, int] = {}
        self.res_add: Dict[str, List[Tuple[Tuple[str, int], int, float]]] = {}
        self.res_touch: Dict[str, List[Tuple[Tuple[str, int], float]]] = {}
        self.cohort_remaining: List[int] = []
        self.ext_remaining_d: List[int] = []
        self.ext_pushes: List[Tuple[Tuple[str, int], float]] = []
        self.opstats_d: Tuple = ()
        self.macs_d = 0
        self.vops_d = 0
        self.dram_d = 0
        self.rel_end = 0.0


class _BWServer:
    """Per-port bandwidth channels: a transfer occupies the earliest-free
    port at that port's share of bandwidth and pays the access latency once
    per REFILL_BYTES chunk (FIFO refill turnaround)."""

    def __init__(self, cfg: MemConfig):
        self.cfg = cfg
        self.ports = [0.0] * cfg.ports
        self.port_bw = cfg.eff_bw / cfg.ports
        self.busy_time = 0.0

    def transfer(self, t: float, nbytes: int) -> float:
        if nbytes <= 0:
            return t
        chunks = -(-nbytes // REFILL_BYTES)
        dur = nbytes / self.port_bw + chunks * self.cfg.latency_ns * 1e-9
        p = min(range(len(self.ports)), key=lambda i: self.ports[i])
        start = max(t, self.ports[p])
        self.ports[p] = start + dur
        self.busy_time += dur
        return self.ports[p]


class _MemState:
    def __init__(self, cfg: MemConfig):
        self.cfg = cfg
        self.resident: Dict[int, int] = {}        # tid -> bytes
        self.last_touch: Dict[int, float] = {}
        self.needed_bytes = 0
        self.obsolete_bytes = 0
        self.trace = OccupancyTrace(cfg.name, cfg.capacity)
        self.writebacks = 0
        self.writeback_bytes = 0
        self.peak_snapshot: List[Tuple[str, int, str]] = []
        self._peak_seen = 0

    @property
    def used(self) -> int:
        return self.needed_bytes + self.obsolete_bytes


@dataclass
class SimResult:
    graph_name: str
    accel_name: str
    total_time: float
    traces: Dict[str, OccupancyTrace]
    access: AccessStats
    ops: OpStats
    writebacks: int
    writeback_bytes: int
    total_macs: int
    total_vector_ops: int
    dram_traffic_bytes: int
    peak_macs_per_s: float
    peak_snapshots: Dict[str, List[Tuple[str, int, str]]] = field(
        default_factory=dict)
    busy_fraction: float = 0.0
    replayed_layers: int = 0       # layers satisfied from the memo templates

    @property
    def pe_utilization(self) -> float:
        return self.total_macs / (self.total_time * self.peak_macs_per_s)

    def peak_needed(self, mem: str = "sram") -> int:
        return self.traces[mem].peak_needed()


class Engine:
    """`policy` selects the list scheduler:
      * "fifo"    — ready-time order (paper-faithful baseline).
      * "mempeak" — occupancy-aware (beyond-paper): among ops ready by the
        time a unit frees, prefer the one with the smallest net SRAM growth
        (output allocation minus bytes its dying inputs release). This
        drains score/intermediate tensors before producing new ones, cutting
        peak needed occupancy — which Stage II converts into smaller minimum
        SRAM and more gate-eligible banks.

    `memoize_layers` (fifo only) turns on the layer-level fast path: the
    first cleanly-simulated instance of each structurally-identical layer is
    recorded, and later instances whose entry state provably reproduces it —
    same needed occupancy, same boundary-tensor residency, enough capacity
    headroom that no eviction can fire, units idle at the boundary — are
    replayed by time-shifting the recorded sub-trace instead of re-running
    the DES. Occupancy deltas, access counts and event ordering are
    bit-identical to the step-by-step run; absolute timestamps agree up to
    float translation error (MEMO_REL_TOL), which is why the golden/PSS
    probe paths leave it off."""

    def __init__(self, graph: WorkloadGraph, accel: AcceleratorConfig,
                 policy: str = "fifo", memoize_layers: bool = False):
        assert policy in ("fifo", "mempeak"), policy
        self.g = graph
        self.accel = accel
        self.policy = policy
        self.memoize_layers = bool(memoize_layers) and policy == "fifo"
        # why replay attempts missed, by guard name — observability for the
        # fast path (a layer counted here ran through the exact DES instead)
        self.memo_misses: Dict[str, int] = {}

    def _layer_structures(self):
        by_layer: Dict[int, List[int]] = {}
        for op in self.g.ops.values():
            by_layer.setdefault(op.layer, []).append(op.oid)
        structures = {l: _LayerStructure(self.g, l, sorted(oids))
                      for l, oids in by_layer.items()}
        # tid -> (owner layer, cohort index): lets records name *foreign*
        # tensors (older layers' weight slabs picked as eviction victims) in
        # a translation-invariant way: (layer delta, index)
        owner: Dict[int, Tuple[int, int]] = {}
        for l, st in structures.items():
            for i, tid in enumerate(st.cohort):
                owner[tid] = (l, i)
        return structures, owner

    # ------------------------------------------------------------------ run
    def run(self) -> SimResult:
        g, accel = self.g, self.accel
        mems = {m.name: _MemState(m) for m in accel.memories}
        bw = {m.name: _BWServer(m) for m in accel.memories}
        dram = accel.dram_name
        access = AccessStats()
        opstats = OpStats()

        # tensor bookkeeping
        remaining = {t.tid: len(t.consumers) for t in g.tensors.values()}
        produced = {t.tid: (t.producer is None) for t in g.tensors.values()}
        # weights / graph inputs start resident in DRAM; set for activations
        # only after a capacity write-back
        in_dram = {t.tid: (t.producer is None) for t in g.tensors.values()}

        pending = {op.oid: sum(0 if produced[i] else 1 for i in op.inputs)
                   for op in g.ops.values()}

        ready: List[Tuple[float, int]] = []
        for op in g.ops.values():
            if pending[op.oid] == 0:
                heapq.heappush(ready, (0.0, op.oid))

        unit_free = [0.0] * accel.sa_count
        unit_mem = list(accel.sa_memory)
        sa_rate = accel.sa_dim * accel.sa_dim * accel.freq_hz
        vpu_rate = accel.vpu_lanes * accel.freq_hz

        def snapshot(mem: _MemState):
            if mem.needed_bytes > mem._peak_seen:
                mem._peak_seen = mem.needed_bytes
                mem.peak_snapshot = [
                    (g.tensors[tid].name, sz, state_bucket(tid))
                    for tid, sz in mem.resident.items()]

        def state_bucket(tid: int) -> str:
            return "needed" if remaining[tid] > 0 or not produced[tid] else "obsolete"

        def add_resident(ms: _MemState, tid: int, t: float):
            if tid in ms.resident:
                ms.last_touch[tid] = t
                return
            sz = g.tensors[tid].size
            ms.resident[tid] = sz
            ms.last_touch[tid] = t
            if state_bucket(tid) == "needed":
                ms.needed_bytes += sz
                ms.trace.event(t, sz, 0)
            else:
                ms.obsolete_bytes += sz
                ms.trace.event(t, 0, sz)
            snapshot(ms)
            if rec is not None:
                d = ms.used - rec.used0.get(ms.cfg.name, ms.used)
                if d > rec.max_used_delta.get(ms.cfg.name, 0):
                    rec.max_used_delta[ms.cfg.name] = d

        def drop_resident(ms: _MemState, tid: int, t: float):
            if rec is not None and rec.valid:
                # capacity eviction: replayable iff it costs no time (the
                # trace delta is recorded with the other events; write-backs
                # invalidate separately). Victims are re-derived at finalize
                # as layer-relative refs, so isomorphic layers evict their
                # own same-shaped ancestors.
                rec.dropped.setdefault(ms.cfg.name, set()).add(tid)
                rec.had_drops = True
            sz = ms.resident.pop(tid)
            ms.last_touch.pop(tid, None)
            if state_bucket(tid) == "needed":
                ms.needed_bytes -= sz
                ms.trace.event(t, -sz, 0)
            else:
                ms.obsolete_bytes -= sz
                ms.trace.event(t, 0, -sz)

        def find_copy(tid: int, exclude: Optional[str] = None) -> Optional[str]:
            """Preferred source holding tid: any on-chip memory, else DRAM."""
            for name, m in mems.items():
                if name != exclude and tid in m.resident:
                    return name
            t = g.tensors[tid]
            if t.producer is None or in_dram.get(tid, False):
                return dram
            return None

        def evict_for(ms: _MemState, need: int, t: float) -> float:
            """Free `need` bytes; returns time after any write-backs."""
            if ms.used + need <= ms.cfg.capacity:
                return t
            # 1) obsolete victims, LRU order (dead data, free to drop)
            victims = sorted(
                (tid for tid in ms.resident if state_bucket(tid) == "obsolete"),
                key=lambda tid: ms.last_touch.get(tid, 0.0))
            for tid in victims:
                if ms.used + need <= ms.cfg.capacity:
                    break
                drop_resident(ms, tid, t)
            # 2) needed victims: free if a copy exists elsewhere, else write
            #    back to DRAM (counted — the capacity criterion of Stage I)
            if ms.used + need > ms.cfg.capacity:
                victims = sorted(
                    (tid for tid in ms.resident
                     if state_bucket(tid) == "needed"),
                    key=lambda tid: ms.last_touch.get(tid, 0.0))
                for tid in victims:
                    if ms.used + need <= ms.cfg.capacity:
                        break
                    sz = ms.resident[tid]
                    if find_copy(tid, exclude=ms.cfg.name) is None:
                        if rec is not None:
                            rec.valid = False    # write-backs cost time
                        t = bw[ms.cfg.name].transfer(t, sz)      # SRAM read
                        t = bw[dram].transfer(t, sz)             # DRAM write
                        access.add_read(ms.cfg.name, sz)
                        access.add_write(dram, sz)
                        ms.writebacks += 1
                        ms.writeback_bytes += sz
                        in_dram[tid] = True
                    drop_resident(ms, tid, t)
            return t

        total_macs = 0
        total_vops = 0
        dram_traffic = 0
        end_time = 0.0
        n_done = 0
        busy_total: Dict[int, float] = {}

        pool: List[Tuple[float, int]] = []      # candidates for "mempeak"

        def mem_delta(oid: int) -> int:
            op = g.ops[oid]
            freed = sum(g.tensors[t].size for t in op.inputs
                        if remaining[t] == 1)
            return g.tensors[op.output].size - freed

        # ---- layer memoization (fifo-only fast path) ------------------------
        memo, owner_map = (self._layer_structures() if self.memoize_layers
                           else (None, {}))
        templates: Dict[Tuple, List[_LayerRecord]] = {}
        sig_fails: Dict[Tuple, int] = {}    # recordings that never templated
        cur_layer: object = object()            # sentinel != any layer id
        rec: Optional[_LayerRecord] = None
        replayed = 0

        def residency_of(tid: int) -> Tuple:
            return tuple(sorted(
                (name, state_bucket(tid)) for name, m2 in mems.items()
                if tid in m2.resident))

        def ref_of(tid: int, l) -> Optional[Tuple]:
            """Translation-invariant name for `tid` as seen from layer l."""
            st = memo.get(l)
            if st is not None:
                i = st.cohort_pos.get(tid)
                if i is not None:
                    return ("c", i)
                i = st.ext_pos.get(tid)
                if i is not None:
                    return ("e", i)
            own = owner_map.get(tid)
            if own is not None and isinstance(l, int):
                return ("d", l - own[0], own[1])
            return ("t", tid)      # unowned (multi-layer DRAM tensor): by id

        def lru_profile(ms: _MemState, l) -> List[Tuple]:
            """Residents in eviction order — (ref, bucket, size), sorted the
            way `evict_for` sorts victims (last_touch, insertion rank)."""
            pos = {tid: i for i, tid in enumerate(ms.resident)}
            order = sorted(ms.resident,
                           key=lambda tid: (ms.last_touch.get(tid, 0.0),
                                            pos[tid]))
            return [(ref_of(tid, l), state_bucket(tid), ms.resident[tid])
                    for tid in order]

        def units_idle_at(t0: float) -> bool:
            return all(u <= t0 + MEMO_REL_TOL * max(1.0, t0)
                       for u in unit_free)

        def open_record() -> None:
            """Start recording the layer at the top of the ready heap, if its
            boundary is clean (heap homogeneous, units idle)."""
            nonlocal rec
            rec = None
            st = memo.get(cur_layer)
            if st is None or not ready:
                return
            if sig_fails.get(st.sig, 0) >= 3:
                return      # e.g. write-back bound: recording is pure cost
            t0 = ready[0][0]
            if any(g.ops[o].layer != cur_layer for _, o in ready):
                return
            if not units_idle_at(t0):
                return
            r = _LayerRecord(cur_layer, t0)
            base = st.oids[0]
            r.heap_pat = sorted((x - t0, o - base) for x, o in ready)
            for name, m2 in mems.items():
                r.needed_entry[name] = m2.needed_bytes
                r.needed0[name] = m2.needed_bytes
                r.obsolete0[name] = m2.obsolete_bytes
                r.used0[name] = m2.used
                r.ev_start[name] = m2.trace.n_events
                r.resident0[name] = dict(m2.resident)
                r.touch0[name] = dict(m2.last_touch)
                r.port_entry[name] = tuple(sorted(
                    max(p - t0, 0.0) for p in bw[name].ports))
                r.busy0[name] = bw[name].busy_time
                r.entry_profile[name] = lru_profile(m2, cur_layer)
            r.reads0 = dict(access.reads_bytes)
            r.writes0 = dict(access.writes_bytes)
            r.unit_busy0 = dict(busy_total)
            r.opstats0 = (dict(opstats.compute), dict(opstats.memory),
                          dict(opstats.idle), dict(opstats.count))
            r.macs0, r.vops0, r.dram0 = total_macs, total_vops, dram_traffic
            for tid in st.ext:
                r.ext_state.append((remaining[tid], in_dram.get(tid, False),
                                    residency_of(tid)))
            rec = r

        def finalize_record() -> None:
            """Diff the finished layer against its entry snapshots and store
            it as a replay template (discard on any exactness hazard)."""
            nonlocal rec
            r, rec = rec, None
            if r is None:
                return
            st = memo[r.layer]
            if not _finalize(r, st):
                sig_fails[st.sig] = sig_fails.get(st.sig, 0) + 1

        def _finalize(r: _LayerRecord, st: _LayerStructure) -> bool:
            if not r.valid or r.ops_done != len(st.oids):
                return False
            t0 = r.t0
            for name, m2 in mems.items():
                et, edn, edo = m2.trace.events_since(r.ev_start[name])
                r.events[name] = (et - t0, edn, edo)
                r.read_d[name] = (access.reads_bytes.get(name, 0)
                                  - r.reads0.get(name, 0))
                r.write_d[name] = (access.writes_bytes.get(name, 0)
                                   - r.writes0.get(name, 0))
                r.bw_busy_d[name] = bw[name].busy_time - r.busy0[name]
                r.ports_exit[name] = [p - t0 for p in bw[name].ports]
                r.needed_d[name] = m2.needed_bytes - r.needed0[name]
                r.obsolete_d[name] = m2.obsolete_bytes - r.obsolete0[name]
                add, touch = [], []
                ent = r.resident0[name]
                dropped = r.dropped.get(name, set())
                for tid, sz in m2.resident.items():
                    if tid in ent:
                        lt = m2.last_touch.get(tid)
                        if lt is not None and lt != r.touch0[name].get(tid):
                            i = st.ext_pos.get(tid)
                            if i is None:
                                return False   # foreign touch: no replay
                            touch.append((i, lt - t0))
                        continue
                    if tid in st.cohort_pos:
                        ref = ("c", st.cohort_pos[tid])
                    elif tid in st.ext_pos:
                        ref = ("e", st.ext_pos[tid])
                    else:
                        return False           # foreign tensor staged in
                    add.append((ref, sz, m2.last_touch.get(tid, t0) - t0))
                gone = []
                for tid in ent:
                    if tid not in m2.resident:
                        if tid not in dropped:
                            return False   # entry tensor vanished untracked
                        gone.append(ref_of(tid, r.layer))
                r.res_add[name] = add
                r.res_touch[name] = touch
                r.res_drop[name] = gone
            r.cohort_remaining = [remaining[tid] for tid in st.cohort]
            r.ext_remaining_d = [remaining[tid] - r.ext_state[i][0]
                                 for i, tid in enumerate(st.ext)]
            r.opstats_d = tuple(
                {k: cur[k] - prev.get(k, 0) for k in cur}
                for cur, prev in zip(
                    (opstats.compute, opstats.memory, opstats.idle,
                     opstats.count), r.opstats0))
            r.macs_d = total_macs - r.macs0
            r.vops_d = total_vops - r.vops0
            r.dram_d = dram_traffic - r.dram0
            r.units_exit = [u - t0 for u in unit_free]
            r.unit_busy_d = {
                u: busy_total.get(u, 0.0) - r.unit_busy0.get(u, 0.0)
                for u in range(accel.sa_count)}
            r.resident0 = r.touch0 = {}      # free the entry snapshots
            r.reads0 = r.writes0 = {}
            r.opstats0 = ()
            lst = templates.setdefault(st.sig, [])
            if len(lst) < 4:
                lst.append(r)
            return True

        def miss(reason: str) -> bool:
            self.memo_misses[reason] = self.memo_misses.get(reason, 0) + 1
            return False

        def try_replay() -> bool:
            nonlocal end_time, total_macs, total_vops, dram_traffic, \
                n_done, replayed
            if not ready:
                return False
            l = g.ops[ready[0][1]].layer
            st = memo.get(l)
            if st is None:
                return False
            cands = templates.get(st.sig)
            if not cands:
                return miss("no-template")
            if any(g.ops[o].layer != l for _, o in ready):
                return miss("mixed-heap")
            t0 = ready[0][0]
            if not units_idle_at(t0):
                return miss("units-busy")
            base = st.oids[0]
            pat = sorted((x - t0, o - base) for x, o in ready)
            ext_now = [(remaining[tid], in_dram.get(tid, False),
                        residency_of(tid)) for tid in st.ext]
            r = None
            why = "entry-state"
            for cand in cands:
                if len(cand.heap_pat) != len(pat) or any(
                        p[1] != q[1] or not _close(p[0], q[0], t0)
                        for p, q in zip(pat, cand.heap_pat)):
                    why = "heap-pattern"
                    continue
                if ext_now != cand.ext_state:
                    why = "ext-state"
                    continue
                ok = True
                for name, m2 in mems.items():
                    if m2.needed_bytes != cand.needed_entry[name]:
                        ok, why = False, "needed-entry"
                        break
                    if (m2.used + cand.max_used_delta.get(name, 0)
                            > m2.cfg.capacity):
                        ok, why = False, "headroom"
                        break
                    if cand.had_drops and (
                            m2.obsolete_bytes != cand.obsolete0[name]
                            or lru_profile(m2, l)
                            != cand.entry_profile[name]):
                        # the template evicted: victim selection repeats
                        # only from an identical relative LRU state
                        ok, why = False, "lru-profile"
                        break
                    pe = tuple(sorted(
                        max(p - t0, 0.0) for p in bw[name].ports))
                    ce = cand.port_entry[name]
                    if len(pe) != len(ce) or any(
                            not _close(a, b, t0) for a, b in zip(pe, ce)):
                        ok, why = False, "port-state"
                        break
                if ok:
                    r = cand
                    break
            if r is None:
                return miss(why)

            def mtid(ref: Tuple) -> int:
                kind, i = ref[0], ref[1]
                if kind == "c":
                    return st.cohort[i]
                if kind == "e":
                    return st.ext[i]
                if kind == "d":
                    return memo[l - i].cohort[ref[2]]
                return i               # ("t", tid): identity

            ready.clear()
            for name, m2 in mems.items():
                rel_t, dn, do = r.events[name]
                if len(rel_t):
                    m2.trace.extend(rel_t + t0, dn, do)
                if r.read_d[name]:
                    access.add_read(name, r.read_d[name])
                if r.write_d[name]:
                    access.add_write(name, r.write_d[name])
                bw[name].busy_time += r.bw_busy_d[name]
                bw[name].ports = [t0 + p for p in r.ports_exit[name]]
                m2.needed_bytes += r.needed_d[name]
                m2.obsolete_bytes += r.obsolete_d[name]
                for ref in r.res_drop.get(name, ()):
                    tid = mtid(ref)
                    del m2.resident[tid]
                    m2.last_touch.pop(tid, None)
                for ref, sz, lt in r.res_add[name]:
                    tid = mtid(ref)
                    m2.resident[tid] = sz
                    m2.last_touch[tid] = t0 + lt
                for i, lt in r.res_touch[name]:
                    m2.last_touch[st.ext[i]] = t0 + lt
            for i, tid in enumerate(st.cohort):
                remaining[tid] = r.cohort_remaining[i]
            for i, tid in enumerate(st.ext):
                remaining[tid] += r.ext_remaining_d[i]
            for o in st.oids:
                produced[g.ops[o].output] = True
            for u in range(accel.sa_count):
                unit_free[u] = t0 + r.units_exit[u]
                d = r.unit_busy_d.get(u, 0.0)
                if d:
                    busy_total[u] = busy_total.get(u, 0.0) + d
            for dst, dd in zip((opstats.compute, opstats.memory,
                                opstats.idle, opstats.count), r.opstats_d):
                for k, v in dd.items():
                    dst[k] = dst.get(k, 0) + v
            total_macs += r.macs_d
            total_vops += r.vops_d
            dram_traffic += r.dram_d
            end_time = max(end_time, t0 + r.rel_end)
            for ref, rel_f in r.ext_pushes:
                tid = mtid(ref)
                for cons in g.tensors[tid].consumers:
                    if g.ops[cons].layer == l:
                        continue
                    pending[cons] -= 1
                    if pending[cons] == 0:
                        heapq.heappush(ready, (t0 + rel_f, cons))
            n_done += len(st.oids)
            replayed += 1
            return True

        while ready or pool:
            if self.policy == "fifo":
                if memo is not None:
                    if g.ops[ready[0][1]].layer != cur_layer:
                        finalize_record()
                        while try_replay():
                            pass
                        if not ready:
                            break
                        cur_layer = g.ops[ready[0][1]].layer
                        open_record()
                rt, oid = heapq.heappop(ready)
            else:
                # admit everything ready by the time the next unit frees
                horizon = min(unit_free)
                if ready:
                    horizon = max(horizon, ready[0][0])
                while ready and ready[0][0] <= horizon:
                    pool.append(heapq.heappop(ready))
                k = min(range(len(pool)),
                        key=lambda i: (mem_delta(pool[i][1]), pool[i][0],
                                       pool[i][1]))
                rt, oid = pool.pop(k)
            op = g.ops[oid]
            # pick the attached unit that can start earliest
            u = min(range(accel.sa_count),
                    key=lambda i: (max(unit_free[i], rt), i))
            ms = mems[unit_mem[u]]
            t = max(unit_free[u], rt)
            t0_sched = t

            # ---- stage inputs into this unit's memory ----------------------
            in_bytes = 0
            t_mem = t
            for tid in op.inputs:
                sz = g.tensors[tid].size
                in_bytes += sz
                if tid in ms.resident:
                    ms.last_touch[tid] = t
                    continue
                src = find_copy(tid, exclude=ms.cfg.name)
                assert src is not None, \
                    f"lost tensor {g.tensors[tid].name}"
                # Dedicated memories talk only to the shared SRAM (paper
                # Fig. 10): DRAM fetches and DM<->DM hops stage through it,
                # and it keeps the copy as backup storage. This is the data
                # hopping the paper identifies as the multi-level cost.
                if src != "sram" and ms.cfg.name != "sram" and "sram" in mems:
                    stage = mems["sram"]
                    if tid not in stage.resident:
                        t_mem = evict_for(stage, sz, t_mem)
                        t_mem = bw[src].transfer(t_mem, sz)
                        access.add_read(src, sz)
                        if src == dram:
                            dram_traffic += sz
                        t_mem = bw["sram"].transfer(t_mem, sz)
                        access.add_write("sram", sz)
                        add_resident(stage, tid, t_mem)
                    src = "sram"
                t_mem = evict_for(ms, sz, t_mem)
                t_mem = bw[src].transfer(t_mem, sz)
                access.add_read(src, sz)
                if src == dram:
                    dram_traffic += sz
                t_mem = bw[ms.cfg.name].transfer(t_mem, sz)
                access.add_write(ms.cfg.name, sz)
                add_resident(ms, tid, t_mem)

            # ---- allocate output -------------------------------------------
            out_t = g.tensors[op.output]
            t_mem = evict_for(ms, out_t.size, t_mem)

            # ---- operand streaming (SRAM reads into the FIFOs) --------------
            t_stream = bw[ms.cfg.name].transfer(t_mem, in_bytes)
            access.add_read(ms.cfg.name, in_bytes)

            # ---- compute -----------------------------------------------------
            if op.op_type == "matmul":
                R, K, C = op.mnk
                fill = 1.0 + (2.0 * accel.sa_dim) / max(K, 1)
                compute = op.macs / sa_rate * fill
            else:
                compute = op.vector_ops / vpu_rate
            c_start = max(t, t_stream)
            finish = c_start + compute

            # ---- output write (overlapped streaming, charged to BW) ---------
            bw[ms.cfg.name].transfer(finish, out_t.size)
            access.add_write(ms.cfg.name, out_t.size)
            add_resident(ms, op.output, finish)

            unit_free[u] = finish
            busy_total[u] = busy_total.get(u, 0.0) + (finish - t)
            end_time = max(end_time, finish)
            total_macs += op.macs
            total_vops += op.vector_ops
            opstats.add(op.tag, compute, max(0.0, t_stream - t),
                        max(0.0, t - rt))
            if rec is not None:
                if op.layer != rec.layer:
                    rec.valid = False    # interleaved layers: not replayable
                else:
                    rec.ops_done += 1
                    rec.rel_end = max(rec.rel_end, finish - rec.t0)

            # ---- completion: outputs exist; inputs may turn obsolete --------
            produced[op.output] = True
            for tid in op.inputs:
                remaining[tid] -= 1
                if remaining[tid] == 0:
                    for m2 in mems.values():
                        if tid not in m2.resident:
                            continue
                        if (op.op_type == "softmax"
                                and g.tensors[tid].size == out_t.size):
                            # in-place: probabilities overwrite the scores.
                            # The tensor was in the needed bucket until this
                            # very completion event.
                            sz = m2.resident.pop(tid)
                            m2.last_touch.pop(tid, None)
                            m2.needed_bytes -= sz
                            m2.trace.event(finish, -sz, 0)
                            continue
                        sz = m2.resident[tid]
                        m2.needed_bytes -= sz
                        m2.obsolete_bytes += sz
                        m2.trace.event(finish, -sz, sz)
            # output was allocated as needed; fix bucket if it has no readers
            if remaining[op.output] == 0:
                sz = ms.resident.get(op.output)
                if sz is not None:
                    ms.needed_bytes -= sz
                    ms.obsolete_bytes += sz
                    ms.trace.event(finish, -sz, sz)

            if rec is not None and rec.valid and op.layer == rec.layer and \
                    any(g.ops[c].layer != rec.layer
                        for c in g.tensors[op.output].consumers):
                i = memo[rec.layer].cohort_pos.get(op.output)
                if i is None:
                    rec.valid = False
                else:
                    rec.ext_pushes.append((("c", i), finish - rec.t0))
            for cons in g.tensors[op.output].consumers:
                pending[cons] -= 1
                if pending[cons] == 0:
                    heapq.heappush(ready, (finish, cons))
            n_done += 1

        assert n_done == len(g.ops), (n_done, len(g.ops))
        wb = sum(m.writebacks for m in mems.values())
        wbb = sum(m.writeback_bytes for m in mems.values())
        from repro_torch.obs.telemetry import default_registry
        tel = default_registry()
        tel.counter("sim.des.runs").inc()
        tel.counter("sim.des.ops").inc(n_done)
        tel.counter("sim.des.layers_replayed").inc(replayed)
        tel.counter("sim.des.writebacks").inc(wb)
        for reason, k in self.memo_misses.items():
            tel.counter(f"sim.des.memo_miss.{reason}").inc(k)
        return SimResult(
            graph_name=g.name, accel_name=accel.name, total_time=end_time,
            traces={name: m.trace for name, m in mems.items()},
            access=access, ops=opstats, writebacks=wb, writeback_bytes=wbb,
            total_macs=total_macs, total_vector_ops=total_vops,
            dram_traffic_bytes=dram_traffic,
            peak_macs_per_s=accel.peak_macs_per_s,
            peak_snapshots={n: m.peak_snapshot for n, m in mems.items()},
            busy_fraction=(sum(busy_total.values())
                           / (accel.sa_count * end_time) if end_time else 0.0),
            replayed_layers=replayed)


def simulate(graph: WorkloadGraph, accel: AcceleratorConfig,
             policy: str = "fifo", memoize_layers: bool = False) -> SimResult:
    return Engine(graph, accel, policy=policy,
                  memoize_layers=memoize_layers).run()


def find_min_sram(graph: WorkloadGraph, accel: AcceleratorConfig,
                  lo_mib: int = 8, hi_mib: int = 256,
                  step_mib: int = 16) -> Tuple[int, SimResult]:
    """Paper's blue loop: smallest SRAM (stepped) with zero capacity-induced
    write-backs; returns (capacity_mib, result at that capacity).

    Write-back count is monotone non-increasing in capacity (a larger SRAM
    strictly relaxes the eviction pressure under the same schedule), so the
    grid scan is a bisection: O(log n) simulations instead of O(n). The
    premise is exact for the "fifo" scheduler used here; capacity-dependent
    timing can in principle reorder a "mempeak" schedule, where this remains
    a first-order assumption."""
    grid = list(range(lo_mib, hi_mib + 1, step_mib)) or [lo_mib]
    if grid[-1] != hi_mib:
        grid.append(hi_mib)          # always probe the stated upper bound
    results: Dict[int, SimResult] = {}

    def run(mib: int) -> SimResult:
        if mib not in results:
            results[mib] = simulate(graph, accel.with_sram_capacity(mib * 2**20))
        return results[mib]

    lo, hi = 0, len(grid) - 1
    if run(grid[hi]).writebacks > 0:          # even the largest still spills
        return grid[hi], run(grid[hi])
    while lo < hi:
        mid = (lo + hi) // 2
        if run(grid[mid]).writebacks == 0:
            hi = mid
        else:
            lo = mid + 1
    return grid[lo], run(grid[lo])
