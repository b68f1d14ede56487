"""Slot-level, time-resolved multi-tenant KV occupancy model; a copy of the
reference package's `repro/traffic/occupancy.py` (host code, model-free).

Composes per-request prefill/decode phases into one on-chip occupancy step
function, without running the model: the KV geometry comes from the
architecture config (MHA vs GQA vs sliding-window vs SSM state, via
`serve.scheduler.kv_bytes_at`), the schedule from a continuous-batching
discrete-event loop (FCFS admission into `num_slots` slots, lockstep decode),
and the timing from a first-order throughput model. The output is a
`TraceBundle` whose `OccupancyTrace` is byte-exact in its bookkeeping
(admitted == retired at drain), so `core.explorer.sweep` and
`core.gating.evaluate` run on it unchanged — serving traffic becomes a
first-class Stage-I workload.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs.telemetry import LATENCY_BUCKETS, Histogram
from repro_torch.serve.scheduler import kv_bytes_at, slot_state_bytes
from repro_torch.sim.trace import AccessStats, OccupancyTrace, TraceBundle
from repro_torch.traffic.generators import RequestSpec, materialize_tokens


@dataclass(frozen=True)
class TimingModel:
    """First-order serving latencies: a prefill costs `prefill_tok_s` per
    prompt token (compute-bound), one lockstep decode iteration costs
    `decode_base_s` plus `decode_slot_s` per active slot (memory-bound)."""
    prefill_tok_s: float = 1.5e-4
    decode_base_s: float = 2e-3
    decode_slot_s: float = 5e-4

    @staticmethod
    def from_arch(cfg, *, peak_macs_per_s: float = 65.5e12,
                  prefill_util: float = 0.35,
                  decode_util: float = 0.02) -> "TimingModel":
        """Scale latencies with the model's per-token work on the paper's
        baseline accelerator (65.5 TMAC/s peak): prefill runs near peak,
        decode is KV-bandwidth-bound so its effective utilization is tiny."""
        macs_per_tok = cfg.active_param_count()
        return TimingModel(
            prefill_tok_s=macs_per_tok / (peak_macs_per_s * prefill_util),
            decode_base_s=5e-4,
            decode_slot_s=macs_per_tok / (peak_macs_per_s * decode_util))


@dataclass
class TrafficStats:
    admitted: int = 0
    finished: int = 0
    rejected: int = 0                  # queue overflow (never with inf queue)
    decode_steps: int = 0
    admitted_bytes: int = 0
    retired_bytes: int = 0
    peak_active_slots: int = 0
    queue_delay_s: List[float] = field(default_factory=list)
    latency_s: List[float] = field(default_factory=list)
    # inter-token gap distribution (standalone mergeable histogram; the
    # fast-forward path bulk-observes so it stays bit-identical to exact)
    tbt: Histogram = field(default_factory=lambda: Histogram(
        "traffic.tbt_s", edges=LATENCY_BUCKETS))

    @property
    def ttft_s(self) -> List[float]:
        """TTFT per request: queue delay is stamped *after* the prefill
        advance, so it already spans arrival -> first token."""
        return self.queue_delay_s

    def percentile_latency(self, q: float) -> float:
        return float(np.percentile(self.latency_s, q)) if self.latency_s else 0.0


@dataclass
class TrafficSim:
    """Result of one traffic run against one architecture."""
    arch_name: str
    bundle: TraceBundle
    stats: TrafficStats
    num_slots: int

    @property
    def trace(self) -> OccupancyTrace:
        return self.bundle.traces["kv"]

    @property
    def total_time(self) -> float:
        return self.bundle.total_time


def simulate_traffic(cfg, requests: Sequence[RequestSpec], *,
                     num_slots: int = 8, max_len: int = 2048,
                     kv_dtype_bytes: int = 2,
                     timing: Optional[TimingModel] = None,
                     mem_name: str = "kv",
                     fidelity: str = "auto", meter=None) -> TrafficSim:
    """Discrete-event continuous batching over `num_slots` KV slots.

    Each admitted request prefills its prompt (occupancy step of the full
    prompt KV + any fixed recurrent state), then gains one token of KV per
    lockstep decode iteration until `output_len` tokens are produced, then
    retires (occupancy drops by everything it held). Admission is FCFS and
    happens between decode iterations, exactly like `ContinuousBatcher`.

    `fidelity`: "exact" steps every lockstep decode iteration individually;
    "pss"/"auto" enable the periodic-steady-state fast forward — stretches
    of iterations with no admission, retirement or KV-growth kink are
    emitted in one vectorized batch. The fast path is *bit-identical* to
    the exact loop (same event list, same float time accumulation via
    cumsum, same stats), so "auto" always takes it; the knob exists to keep
    the two paths regression-testable against each other."""
    if fidelity not in ("exact", "pss", "auto"):
        raise ValueError(f"fidelity must be exact|pss|auto, got {fidelity}")
    timing = timing or TimingModel.from_arch(cfg)
    reqs = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
    pending = list(reversed(reqs))               # pop() = earliest arrival
    state_b = slot_state_bytes(cfg)

    cap = num_slots * (kv_bytes_at(cfg, max_len, kv_dtype_bytes) + state_b)
    trace = OccupancyTrace(mem_name, cap)
    access = AccessStats()
    stats = TrafficStats()

    @dataclass
    class _Slot:
        req: RequestSpec
        ctx: int                      # current context length
        produced: int                 # decoded tokens so far
        bytes: int
        t_admit: float
        tok_t: float                  # time of the last emitted token

    slots: List[Optional[_Slot]] = [None] * num_slots
    t = 0.0

    def admit() -> None:
        nonlocal t
        for i in range(num_slots):
            if slots[i] is not None or not pending:
                continue
            if pending[-1].arrival_s > t:
                break                         # FCFS: don't skip ahead in time
            r = pending.pop()
            ctx = min(r.prompt_len, max_len)
            t += ctx * timing.prefill_tok_s   # prefills serialize on the pool
            b = kv_bytes_at(cfg, ctx, kv_dtype_bytes) + state_b
            trace.event(t, b, 0)
            if meter is not None:
                meter.record(t, b, 0, rid=r.rid, tenant=r.prefix_id,
                             cause="admission")
            access.add_write(mem_name, b)
            slots[i] = _Slot(r, ctx, 0, b, r.arrival_s, t)
            stats.admitted += 1
            stats.admitted_bytes += b
            stats.queue_delay_s.append(t - r.arrival_s)
            stats.peak_active_slots = max(
                stats.peak_active_slots, sum(s is not None for s in slots))
            if r.output_len <= 1:
                retire(i)       # prefill's first token already satisfied it

    def retire(i: int) -> None:
        s = slots[i]
        trace.event(t, -s.bytes, 0)
        if meter is not None:
            meter.record(t, -s.bytes, 0, rid=s.req.rid,
                         tenant=s.req.prefix_id)
        stats.retired_bytes += s.bytes
        stats.finished += 1
        stats.latency_s.append(t - s.req.arrival_s)
        slots[i] = None

    def kv_growth(ctx: int) -> int:
        if ctx >= max_len:
            return 0
        return (kv_bytes_at(cfg, ctx + 1, kv_dtype_bytes)
                - kv_bytes_at(cfg, ctx, kv_dtype_bytes))

    def ff_window(active: List[int]) -> int:
        """Lockstep iterations that are provably uneventful: no retirement,
        no KV-growth kink (saturation), no admission opportunity. Within
        the window every slot's growth is constant, so the iterations can
        be emitted in one vectorized batch, bit-identically."""
        k = min(slots[i].req.output_len - 1 - slots[i].produced
                for i in active) - 1          # stop before any retirement
        for i in active:
            s = slots[i]
            if s.ctx >= max_len:
                continue
            b0 = kv_bytes_at(cfg, s.ctx, kv_dtype_bytes)
            d1 = kv_bytes_at(cfg, s.ctx + 1, kv_dtype_bytes) - b0
            w = max_len - s.ctx
            # shrink to an affine stretch (handles local-window kinks)
            while w > 1 and (kv_bytes_at(cfg, s.ctx + w, kv_dtype_bytes)
                             - b0) != w * d1:
                w //= 2
            k = min(k, w)
        return k

    def fast_forward(active: List[int], k: int, dt: float) -> None:
        nonlocal t
        # sequential float accumulation: cumsum([t, dt, ...]) reproduces the
        # exact loop's `t += dt` chain bit-for-bit
        ts = np.cumsum(np.r_[t, np.full(k, dt)])[1:]
        if pending and any(s is None for s in slots):
            a = pending[-1].arrival_s
            stop = int(np.searchsorted(ts, a, side="left"))
            if stop < k:
                k, ts = stop + 1, ts[:stop + 1]   # admit on the next pass
        stats.decode_steps += k
        grow: List[int] = []
        grow_meta: List[RequestSpec] = []
        for i in active:
            s = slots[i]
            d1 = kv_growth(s.ctx)
            access.add_read(mem_name,
                            k * s.bytes + d1 * (k * (k - 1) // 2))
            if d1:
                grow.append(d1)
                grow_meta.append(s.req)
                s.bytes += k * d1
                access.add_write(mem_name, k * d1)
                stats.admitted_bytes += k * d1
            s.ctx = min(s.ctx + k, max_len)
            s.produced += k
            # diff over [last token, window tokens] yields the same float
            # subtractions the exact loop performs step by step
            stats.tbt.observe_array(np.diff(np.r_[s.tok_t, ts]))
            s.tok_t = float(ts[-1])
        if grow:
            trace.extend(np.repeat(ts, len(grow)),
                         np.tile(np.asarray(grow, np.int64), k),
                         np.zeros(k * len(grow), np.int64))
            if meter is not None:
                # element-for-element mirror of the bulk emission above
                # (ts-major, slots inner), so the meter's trace stays a
                # verbatim copy of the sim's
                meter.record_bulk(
                    np.repeat(ts, len(grow)),
                    np.tile(np.asarray(grow, np.int64), k),
                    np.zeros(k * len(grow), np.int64),
                    rids=[r.rid for r in grow_meta] * k,
                    tenants=[r.prefix_id for r in grow_meta] * k,
                    cause="decode_growth")
        t = float(ts[-1])

    while pending or any(s is not None for s in slots):
        admit()
        active = [i for i in range(num_slots) if slots[i] is not None]
        if not active:
            if not pending:
                break        # everything retired at admission (1-token reqs)
            # pool drained: jump to the next arrival (occupancy is zero in
            # the gap — the fluctuation power gating feeds on)
            t = max(t, pending[-1].arrival_s)
            continue
        if fidelity != "exact":
            k = ff_window(active)
            if k > 1:
                fast_forward(active, k,
                             timing.decode_base_s
                             + timing.decode_slot_s * len(active))
                continue
        t += timing.decode_base_s + timing.decode_slot_s * len(active)
        stats.decode_steps += 1
        for i in active:
            s = slots[i]
            stats.tbt.observe(t - s.tok_t)
            s.tok_t = t
            # attention reads all resident KV, then appends one row (the
            # bounded cache stops growing at max_len, like ContinuousBatcher)
            access.add_read(mem_name, s.bytes)
            nxt_ctx = min(s.ctx + 1, max_len)
            d = (kv_bytes_at(cfg, nxt_ctx, kv_dtype_bytes)
                 - kv_bytes_at(cfg, s.ctx, kv_dtype_bytes))
            s.ctx = nxt_ctx
            s.produced += 1
            if d:
                s.bytes += d
                trace.event(t, d, 0)
                if meter is not None:
                    meter.record(t, d, 0, rid=s.req.rid,
                                 tenant=s.req.prefix_id,
                                 cause="decode_growth")
                access.add_write(mem_name, d)
                stats.admitted_bytes += d
            # the prefill's argmax already yielded token #1, so `output_len`
            # generations need output_len - 1 decode iterations
            if s.produced >= s.req.output_len - 1:
                retire(i)

    bundle = TraceBundle(graph_name=f"{cfg.name}-traffic",
                         total_time=max(t, 1e-9),
                         traces={mem_name: trace}, access=access)
    return TrafficSim(cfg.name, bundle, stats, num_slots)


# ---------------------------------------------------------------------------
# Shared-prefix occupancy analysis (page-granular, model-free)
# ---------------------------------------------------------------------------

@dataclass
class PrefixTrafficStats(TrafficStats):
    prefix_hits: int = 0
    prefix_tokens_reused: int = 0
    cow_splits: int = 0
    evicted_pages: int = 0


def simulate_prefix_traffic(cfg, requests: Sequence[RequestSpec], *,
                            num_slots: int = 8, page_size: int = 16,
                            num_pages: Optional[int] = None,
                            max_len: int = 2048, kv_dtype_bytes: int = 2,
                            timing: Optional[TimingModel] = None,
                            vocab_size: int = 50000,
                            seed: int = 0, meter=None) -> TrafficSim:
    """Page-granular continuous batching with prefix sharing, model-free.

    The same host machinery the real batcher runs — `RadixPrefixIndex`
    probe/insert, refcounted COW page allocation, LRU leaf eviction —
    driven by materialized token streams instead of a JAX model, with the
    KV geometry from `serve.paged.page_bytes` and the timing from the
    first-order `TimingModel` (prefix hits skip the matched run's prefill
    time). The result is a `TraceBundle` carrying the **dual traces**:
    "kv" is physical occupancy (unique slot-referenced pages as needed,
    cache-resident pages as obsolete) and "kv_logical" the per-slot demand
    sum — so `core.explorer.sweep` / `traffic.campaign` price banking and
    gating against true residency unchanged, and logical-vs-physical is
    the sharing headroom. Full-attention KV only (recurrent state is
    context-independent and contributes no sharable bytes)."""
    from repro_torch.serve.paged import (page_bytes as paged_page_bytes,
                                         pages_for)
    from repro_torch.serve.prefix import SharedKVLedger

    timing = timing or TimingModel.from_arch(cfg)
    ps = page_size
    slot_cap_pages = pages_for(max_len, ps)
    if num_pages is None:
        # live worst case + an equal-size allowance for the reuse cache
        num_pages = 1 + 2 * num_slots * slot_cap_pages
    pb = paged_page_bytes(cfg, ps, kv_dtype_bytes)
    ledger = SharedKVLedger(num_pages, pb, ps, num_slots=num_slots,
                            max_pages_per_slot=slot_cap_pages)
    ledger.meter = meter
    access = AccessStats()
    stats = PrefixTrafficStats()
    mem_name = "kv"

    def worst_pages(r: RequestSpec) -> int:
        S = min(r.prompt_len, max_len)
        w = pages_for(min(S + max(r.output_len - 1, 0), max_len), ps)
        return w + (1 if S % ps and r.output_len > 1 else 0)

    # reject requests no drained pool could ever hold (the batcher raises
    # OutOfPages at submit for the same condition) — admitting them would
    # stall the FCFS queue forever
    reqs, rejected = [], 0
    for r in sorted(requests, key=lambda r: (r.arrival_s, r.rid)):
        if (worst_pages(r) > num_pages - 1
                or pages_for(min(r.prompt_len, max_len), ps)
                > slot_cap_pages):
            rejected += 1
        else:
            reqs.append(r)
    stats.rejected = rejected
    tokens = materialize_tokens(reqs, vocab_size, seed)
    pending = list(reversed(list(zip(reqs, tokens))))

    @dataclass
    class _Slot:
        req: RequestSpec
        ctx: int
        produced: int
        tok_t: float

    slots: List[Optional[_Slot]] = [None] * num_slots
    reserved = [0] * num_slots
    t = 0.0

    def available() -> int:
        return ledger.allocator.n_free - sum(reserved)

    def admit() -> None:
        nonlocal t
        for i in range(num_slots):
            if slots[i] is not None or not pending:
                continue
            r, toks = pending[-1]
            if r.arrival_s > t:
                break                    # FCFS: don't skip ahead in time
            S = min(r.prompt_len, max_len)
            toks = toks[:S]
            worst_total = pages_for(
                min(S + max(r.output_len - 1, 0), max_len), ps)
            cow_extra = 1 if (S % ps and r.output_len > 1) else 0
            match = ledger.index.probe(toks, limit=S - 1)
            short = worst_total - len(match.pages) + cow_extra - available()
            while short > 0:
                freed = ledger.evict_for(short, t)
                if not freed:
                    break
                stats.evicted_pages += freed
                match = ledger.index.probe(toks, limit=S - 1)
                short = (worst_total - len(match.pages) + cow_extra
                         - available())
            if short > 0:
                break                    # FCFS: wait for pages
            pending.pop()
            m = match.tokens(ps)
            fresh_n = pages_for(S, ps) - len(match.pages)
            t += (S - m) * timing.prefill_tok_s       # prefill skip
            if meter is not None:
                ledger.set_slot_meta(i, r.rid, r.prefix_id)
            ledger.admit(i, fresh_n, t, shared=match.pages)
            ledger.insert_run(toks, ledger.slot_pages[i], t)
            reserved[i] = worst_total - len(match.pages) + cow_extra - fresh_n
            slots[i] = _Slot(r, S, 0, t)
            access.add_write(mem_name, (S - m) * (pb // ps))
            stats.admitted += 1
            stats.admitted_bytes += fresh_n * pb
            if m:
                stats.prefix_hits += 1
                stats.prefix_tokens_reused += m
            stats.queue_delay_s.append(t - r.arrival_s)
            stats.peak_active_slots = max(
                stats.peak_active_slots, sum(s is not None for s in slots))
            if r.output_len <= 1:
                retire(i)

    def retire(i: int) -> None:
        s = slots[i]
        freed = ledger.retire(i, t)
        stats.retired_bytes += freed * pb
        stats.finished += 1
        stats.latency_s.append(t - s.req.arrival_s)
        reserved[i] = 0
        slots[i] = None

    while pending or any(s is not None for s in slots):
        admit()
        active = [i for i in range(num_slots) if slots[i] is not None]
        if not active:
            if not pending:
                break
            nxt = max(t, pending[-1][0].arrival_s)
            if nxt == t:
                # the head arrived, every slot is free, and admit() still
                # failed: the feasibility filter should make this
                # unreachable — fail loudly rather than spin forever
                raise RuntimeError(
                    "prefix traffic sim stalled: queue head cannot admit "
                    "into a drained pool")
            t = nxt
            continue
        t += timing.decode_base_s + timing.decode_slot_s * len(active)
        stats.decode_steps += 1
        for i in active:
            s = slots[i]
            stats.tbt.observe(t - s.tok_t)
            s.tok_t = t
            access.add_read(mem_name, pages_for(s.ctx, ps) * pb)
            if s.ctx < max_len:
                idx = s.ctx // ps
                pages = ledger.slot_pages[i]
                if idx < len(pages):
                    if ledger.allocator.refcount(pages[idx]) > 1:
                        ledger.cow(i, idx, t)     # divergent write: COW split
                        reserved[i] -= 1
                        stats.cow_splits += 1
                else:
                    ledger.grow(i, idx + 1, t)
                    reserved[i] -= 1
                access.add_write(mem_name, pb // ps)
                s.ctx += 1
            s.produced += 1
            if s.produced >= s.req.output_len - 1:
                retire(i)

    bundle = TraceBundle(graph_name=f"{cfg.name}-prefix-traffic",
                         total_time=max(t, 1e-9),
                         traces={"kv": ledger.trace,
                                 "kv_logical": ledger.logical},
                         access=access)
    return TrafficSim(cfg.name, bundle, stats, num_slots)


# ---------------------------------------------------------------------------
# Speculative-decoding occupancy analysis (page-granular, model-free)
# ---------------------------------------------------------------------------

@dataclass
class SpecTrafficStats(TrafficStats):
    spec_rounds: int = 0
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    rolled_back_pages: int = 0

    @property
    def acceptance_rate(self) -> float:
        """Accepted draft tokens / drafted tokens (the bonus token each
        round contributes is excluded, matching the usual definition)."""
        if not self.drafted_tokens:
            return 0.0
        return (self.accepted_tokens - self.spec_rounds) / self.drafted_tokens


def simulate_spec_traffic(cfg, requests: Sequence[RequestSpec], *,
                          num_slots: int = 8, page_size: int = 16,
                          num_pages: Optional[int] = None,
                          max_len: int = 2048, spec_k: int = 4,
                          acceptance: float = 0.7,
                          draft_kv_frac: float = 0.5,
                          kv_dtype_bytes: int = 2,
                          timing: Optional[TimingModel] = None,
                          seed: int = 0, meter=None) -> TrafficSim:
    """Page-granular continuous batching under speculative decoding.

    Mirrors the real `PagedContinuousBatcher(speculate_k=...)` loop through
    the same `PagedKVLedger` (both page lanes, draft pages priced at
    `draft_kv_frac` of a target page) without running a model: each active
    slot per lockstep round bursts its lanes to the k+1-row verify window,
    accepts ``m = 1 + <leading Bernoulli(acceptance) run over k drafts>``
    tokens, then rolls the rejected suffix back via
    `PagedKVLedger.truncate_rows` — so the trace carries the speculative
    occupancy signature (per-round sawtooth of burst/rollback deltas) that
    the serving path produces, and feeds Stage-II (`core.explorer.sweep`,
    `traffic.campaign`) unchanged. Round latency scales the lockstep decode
    iteration by ``1 + (k+1) * draft_kv_frac``: one verify pass plus k+1
    draft steps at the draft's relative cost (for self-speculation the KV
    fraction and the compute fraction are both the kept-layer fraction)."""
    from repro_torch.serve.paged import PagedKVLedger, pages_for
    from repro_torch.serve.paged import page_bytes as paged_page_bytes

    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    if not 0.0 <= acceptance <= 1.0:
        raise ValueError(f"acceptance must be in [0, 1], got {acceptance}")
    timing = timing or TimingModel.from_arch(cfg)
    ps = page_size
    V = spec_k + 1
    pb = paged_page_bytes(cfg, ps, kv_dtype_bytes)
    draft_pb = max(1, int(round(pb * draft_kv_frac)))
    draft_time = 1.0 + V * draft_kv_frac      # round time vs one decode step
    if num_pages is None:
        num_pages = 1 + 2 * num_slots * pages_for(max_len, ps)
    ledger = PagedKVLedger(num_pages, pb, ps)
    ledger.enable_draft_lane(draft_pb)
    ledger.meter = meter
    access = AccessStats()
    stats = SpecTrafficStats()
    rng = np.random.default_rng(seed)
    mem_name = "kv"

    def worst_pages(r: RequestSpec) -> int:
        """Per-lane worst case: the verify window overshoots the final
        context by up to k rows before the last rollback truncates it."""
        S = min(r.prompt_len, max_len)
        extra = spec_k if r.output_len > 1 else 0
        return pages_for(min(S + max(r.output_len - 1, 0) + extra, max_len),
                         ps)

    reqs, rejected = [], 0
    for r in sorted(requests, key=lambda r: (r.arrival_s, r.rid)):
        if 2 * worst_pages(r) > num_pages - 1:
            rejected += 1
        else:
            reqs.append(r)
    stats.rejected = rejected
    pending = list(reversed(reqs))

    @dataclass
    class _Slot:
        req: RequestSpec
        ctx: int
        produced: int
        tok_t: float

    slots: List[Optional[_Slot]] = [None] * num_slots
    reserved = [0] * num_slots
    t = 0.0

    def available() -> int:
        return ledger.allocator.n_free - sum(reserved)

    def admit() -> None:
        nonlocal t
        for i in range(num_slots):
            if slots[i] is not None or not pending:
                continue
            r = pending[-1]
            if r.arrival_s > t:
                break                    # FCFS: don't skip ahead in time
            if 2 * worst_pages(r) > available():
                break                    # FCFS: wait for pages
            pending.pop()
            S = min(r.prompt_len, max_len)
            npg = pages_for(S, ps)
            # both lanes prefill the full prompt (the draft lane never
            # shares, so speculation costs a second, cheaper prefill)
            t += S * timing.prefill_tok_s * (1.0 + draft_kv_frac)
            if meter is not None:
                ledger.set_slot_meta(i, r.rid, r.prefix_id)
            ledger.admit(i, npg, t)
            ledger.admit_draft(i, npg, t)
            reserved[i] = 2 * (worst_pages(r) - npg)
            slots[i] = _Slot(r, S, 0, t)
            access.add_write(mem_name, S * (pb // ps) + S * (draft_pb // ps))
            stats.admitted += 1
            stats.admitted_bytes += npg * (pb + draft_pb)
            stats.queue_delay_s.append(t - r.arrival_s)
            stats.peak_active_slots = max(
                stats.peak_active_slots, sum(s is not None for s in slots))
            if r.output_len <= 1:
                retire(i)

    def retire(i: int) -> None:
        s = slots[i]
        held = (len(ledger.slot_pages[i]) * pb
                + len(ledger.draft_pages.get(i, [])) * draft_pb)
        ledger.retire(i, t)
        stats.retired_bytes += held
        stats.finished += 1
        stats.latency_s.append(t - s.req.arrival_s)
        reserved[i] = 0
        slots[i] = None

    while pending or any(s is not None for s in slots):
        admit()
        active = [i for i in range(num_slots) if slots[i] is not None]
        if not active:
            if not pending:
                break
            nxt = max(t, pending[-1].arrival_s)
            if nxt == t:
                raise RuntimeError(
                    "spec traffic sim stalled: queue head cannot admit "
                    "into a drained pool")
            t = nxt
            continue
        # one speculative round per active slot: verify pass + k+1 draft
        # steps, all inside one lockstep iteration's wall-clock envelope
        t += (timing.decode_base_s
              + timing.decode_slot_s * len(active)) * draft_time
        stats.decode_steps += 1
        for i in active:
            s = slots[i]
            rem = s.req.output_len - 1 - s.produced
            # burst: both lanes grow to the verify window's worst case
            burst_rows = min(s.ctx + V, max_len)
            npg = pages_for(burst_rows, ps)
            fresh = npg - len(ledger.slot_pages[i])
            if fresh > 0:
                ledger.grow(i, npg, t)
                ledger.grow_draft(i, npg, t)
                reserved[i] -= 2 * fresh
                stats.admitted_bytes += fresh * (pb + draft_pb)
            # target reads the window's pages once (batched verify); the
            # draft re-reads them for each of its k+1 sequential steps
            access.add_read(mem_name, npg * pb + V * npg * draft_pb)
            access.add_write(mem_name, V * (pb // ps) + V * (draft_pb // ps))
            # m = 1 + leading Bernoulli(acceptance) run over the k drafts
            draws = rng.random(spec_k) < acceptance
            lead = spec_k if draws.all() else int(np.argmin(draws))
            m = min(1 + lead, rem)
            s.ctx = min(s.ctx + m, max_len)
            s.produced += m
            stats.spec_rounds += 1
            stats.drafted_tokens += spec_k
            stats.accepted_tokens += m
            stats.tbt.observe_array(np.diff(np.r_[s.tok_t,
                                                  np.full(m, t)]))
            s.tok_t = t
            # rollback: truncate the rejected suffix out of both lanes
            ft, fd = ledger.truncate_rows(i, s.ctx, t)
            freed = len(ft) + len(fd)
            if freed:
                reserved[i] += freed
                stats.rolled_back_pages += freed
            if s.produced >= s.req.output_len - 1:
                retire(i)

    bundle = TraceBundle(graph_name=f"{cfg.name}-spec-traffic",
                         total_time=max(t, 1e-9),
                         traces={mem_name: ledger.trace}, access=access)
    return TrafficSim(cfg.name, bundle, stats, num_slots)


def utilization_summary(sim: TrafficSim) -> Dict[str, float]:
    """Headline occupancy numbers + serving SLO percentiles for reports."""
    tr = sim.trace
    st = sim.stats
    ttft = st.queue_delay_s
    return {
        "peak_bytes": float(tr.peak_needed()),
        "mean_bytes": tr.time_weighted_mean(sim.total_time),
        "capacity_bytes": float(tr.capacity),
        "peak_frac_of_capacity": (tr.peak_needed() / tr.capacity
                                  if tr.capacity else 0.0),
        "finished": float(st.finished),
        "p50_latency_s": st.percentile_latency(50),
        "p95_latency_s": st.percentile_latency(95),
        "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft else 0.0,
        "ttft_p99_s": float(np.percentile(ttft, 99)) if ttft else 0.0,
        "tbt_p50_s": st.tbt.quantile(0.5) if st.tbt.count else 0.0,
        "tbt_p99_s": st.tbt.quantile(0.99) if st.tbt.count else 0.0,
    }
