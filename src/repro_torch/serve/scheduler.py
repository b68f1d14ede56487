"""Continuous batching over dense decode slots, and the scheduler types
shared by the port's batchers (port of the reference's
`repro/serve/scheduler.py`): `Request`, the priority `AdmissionQueue`,
`SchedulerStats`, the KV-cache geometry (`kv_bytes_at`,
`slot_state_bytes`, `kv_slot_budget`) and `ContinuousBatcher`.

`ContinuousBatcher` is the dense reference batcher: each slot holds its own
batch-1 `max_len` cache and decodes one token per host round trip, exact
but host-bound; the production path is `serve.paged`. With an enabled
`Telemetry` registry it keeps per-request timelines, `serve.dense.*`
counters, spans and SLO percentiles on its logical clock; with a `meter`
it mirrors every trace delta to a streaming `obs.energy.BankEnergyMeter`."""
from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.obs.slo import (RequestTimeline, SLOSummary, SLOTracker,
                                 attach_energy_percentiles)
from repro_torch.obs.telemetry import noop_registry
from repro_torch.sim.trace import AccessStats, OccupancyTrace, TraceBundle


def slot_state_bytes(cfg) -> int:
    """Sequence-length-independent per-slot state (SSM + RG-LRU blocks)."""
    total = 0
    kinds = cfg.layer_kinds()
    if cfg.ssm is not None:
        s = cfg.ssm
        n_ssm = sum(1 for k in kinds if k == "ssm")
        total += s.num_heads(cfg.d_model) * s.head_dim * s.state_dim * 4 * n_ssm
    if cfg.rglru is not None:
        r = cfg.rglru
        w = r.lru_width(cfg.d_model)
        n_rg = sum(1 for k in kinds if k == "rglru")
        # fp32 recurrent state + the causal-conv tail window (fp16)
        total += n_rg * (w * 4 + r.conv_width * w * 2)
    return total


def kv_bytes_at(cfg, pos: int, kv_dtype_bytes: int = 2) -> int:
    """KV-cache bytes held by ONE sequence at context length `pos`.

    Full-attention layers grow linearly; sliding-window layers saturate at
    `local_window` tokens; SSM/RG-LRU blocks contribute nothing here (their
    fixed state is `slot_state_bytes`)."""
    per_full = 0
    per_local = 0
    for kind in cfg.layer_kinds():
        if kind == "full":
            per_full += 1
        elif kind in ("local", "chunked") and cfg.local_window:
            per_local += 1
    row = 2 * cfg.kv_dim * kv_dtype_bytes            # K + V for one token
    total = per_full * pos * row
    if per_local:
        total += per_local * min(cfg.local_window, pos) * row
    return total


def kv_slot_budget(cfg, hbm_bytes: float, max_len: int,
                   weight_dtype_bytes: int = 2,
                   kv_dtype_bytes: int = 2) -> Optional[int]:
    """How many concurrent sequences fit a device-memory budget; None when
    the architecture holds no per-sequence state at all."""
    weights = cfg.param_count() * weight_dtype_bytes
    per_slot = kv_bytes_at(cfg, max_len, kv_dtype_bytes) + slot_state_bytes(cfg)
    if per_slot == 0:
        return None
    return max(0, int((hbm_bytes - weights) // per_slot))


@dataclass
class Request:
    rid: int
    tokens: np.ndarray                 # (prompt_len,)
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # admission class: higher admits first; on the paged batcher a queued
    # higher-priority request may preempt a lower-priority active slot
    # instead of waiting (ties decode FCFS)
    priority: int = 0
    # billing identity for per-tenant attribution (None = untagged)
    tenant: Optional[str] = None
    # filled by the scheduler
    output: List[int] = field(default_factory=list)
    # per-token last-position logits, filled only by batchers running with
    # collect_logits=True
    logits: List[np.ndarray] = field(default_factory=list)
    # lifecycle stamps on both clocks: `submitted_s`/`finished_s` are on the
    # engine's logical sim clock (the time base of the occupancy trace);
    # `*_wall_s` are time.perf_counter stamps for host-side profiling
    submitted_s: float = 0.0
    finished_s: float = 0.0
    submitted_wall_s: float = 0.0
    finished_wall_s: float = 0.0
    # times this request was preempted and requeued (paged batcher only)
    preemptions: int = 0
    # lifecycle on the engine's logical clock, stamped when the engine runs
    # with an enabled Telemetry registry (None otherwise)
    timeline: Optional[RequestTimeline] = None

    @property
    def latency_s(self) -> float:
        """Submit-to-finish on the engine's logical sim clock."""
        return self.finished_s - self.submitted_s

    @property
    def wall_latency_s(self) -> float:
        return self.finished_wall_s - self.submitted_wall_s


class AdmissionQueue:
    """Priority admission queue: descending `Request.priority`, FIFO within
    a class. A request requeued after preemption re-enters at the back of
    its class (a fresh sequence number), so a preempt/re-admit cycle cannot
    starve its peers."""

    def __init__(self):
        self._heap: List = []
        self._seq = itertools.count()

    def push(self, req: Request) -> None:
        heapq.heappush(self._heap, (-req.priority, next(self._seq), req))

    def pop(self) -> Request:
        return heapq.heappop(self._heap)[2]

    def peek(self) -> Request:
        return self._heap[0][2]

    def __len__(self) -> int:
        return len(self._heap)

    def __iter__(self) -> Iterator[Request]:
        return (item[2] for item in sorted(self._heap))


@dataclass
class SchedulerStats:
    admitted: int = 0
    finished: int = 0
    decode_steps: int = 0
    prefills: int = 0
    preemptions: int = 0
    peak_active_slots: int = 0
    admitted_kv_bytes: int = 0
    retired_kv_bytes: int = 0
    # prefix-cache reuse (stays zero on engines without a prefix index)
    prefix_hits: int = 0
    prefix_tokens_reused: int = 0
    # per-request serving SLOs on the logical sim clock (populated when the
    # engine runs with an enabled Telemetry registry; zero otherwise)
    ttft_p50_s: float = 0.0
    ttft_p99_s: float = 0.0
    tbt_p50_s: float = 0.0
    tbt_p99_s: float = 0.0
    e2e_p50_s: float = 0.0
    e2e_p99_s: float = 0.0


class ContinuousBatcher:
    """Priority continuous batching (FIFO within a class) over `num_slots`
    dense decode slots.

    Admission prefills a queued request into a free slot's own batch-1
    `max_len` cache; every step decodes one token for each live slot
    (`DecoderLM.decode_step`, which attends through `kernels.gqa_decode`)
    and retires slots on EOS or `max_new_tokens`. A slot keeps decoding
    past `max_len`: its cache then overwrites the last row, as the
    reference's clamped write does, and the trace stops growing.

    Emits a time-resolved slot-occupancy trace on a logical clock
    (`step_time_s` per decode iteration, `prefill_tok_s` per prefilled
    token): every admission, decoded token and retirement is an
    `OccupancyTrace` event, the Stage-I artifact `core.explorer.sweep`
    consumes (`occupancy_bundle()`). Spans and SLO timelines record on the
    same logical clock (a passed-in registry has its clock bound here), and
    a `meter` receives each trace delta tagged with its request and
    tenant."""

    def __init__(self, model, params, *, num_slots: int = 4,
                 max_len: int = 128, kv_dtype_bytes: int = 2,
                 step_time_s: float = 1e-3, prefill_tok_s: float = 5e-5,
                 on_long_prompt: str = "reject", telemetry=None,
                 meter=None):
        if getattr(getattr(model, "cfg", None), "is_encdec", False):
            raise TypeError(
                f"{model.cfg.name} is an encoder-decoder: ContinuousBatcher "
                "has no encoder-decoder path (its requests carry no "
                "frames), as in the reference; serve it with BatchedServer")
        if on_long_prompt not in ("reject", "truncate"):
            raise ValueError("on_long_prompt must be 'reject' or 'truncate'")
        self.model = model
        self.params = params
        self.num_slots = num_slots
        self.max_len = max_len
        self.on_long_prompt = on_long_prompt
        # spans/SLOs record on the batcher's logical sim clock, the time base
        # of the occupancy trace; bind_clock raises if another engine
        # already owns the registry's clock
        self.tel = telemetry if telemetry is not None else noop_registry()
        if telemetry is not None:
            telemetry.bind_clock(lambda: self._sim_t, owner=self)
        self._slo = (SLOTracker(self.tel, "serve.dense")
                     if self.tel.enabled else None)
        self.queue = AdmissionQueue()
        self.slots: List[Optional[Request]] = [None] * num_slots
        self._tokens_by_rid: Dict[int, int] = {}   # retired, for J/token
        self.stats = SchedulerStats()
        # per-slot batch-1 caches, as the reference keeps them
        self._caches: List[Any] = [None] * num_slots
        self._next_tok: List[Optional[int]] = [None] * num_slots

        # ---- slot-occupancy trace (logical clock) -------------------------
        self.cfg = getattr(model, "cfg", None)
        self.kv_dtype_bytes = kv_dtype_bytes
        self.step_time_s = step_time_s
        self.prefill_tok_s = prefill_tok_s
        self._sim_t = 0.0
        self._slot_bytes = [0] * num_slots           # resident KV per slot
        self._slot_ctx = [0] * num_slots             # context length per slot
        cap = 0
        if self.cfg is not None:
            cap = num_slots * (kv_bytes_at(self.cfg, max_len, kv_dtype_bytes)
                               + slot_state_bytes(self.cfg))
        self.trace = OccupancyTrace("kv", cap)
        # optional streaming BankEnergyMeter: every trace delta below is
        # mirrored to it with the owning request/tenant tag
        self.meter = meter
        self.access = AccessStats()

    # ------------------------------------------------------------ client API
    def submit(self, req: Request) -> None:
        S = int(len(req.tokens))
        if S > self.max_len:
            if self.on_long_prompt == "truncate":
                req.tokens = np.asarray(req.tokens)[: self.max_len]
            else:
                raise ValueError(
                    f"prompt of {S} tokens exceeds max_len={self.max_len}; "
                    "truncate it or construct the batcher with "
                    "on_long_prompt='truncate'")
        req.submitted_wall_s = time.perf_counter()
        req.submitted_s = self._sim_t
        if self.tel.enabled:
            req.timeline = RequestTimeline(rid=req.rid, submit_t=self._sim_t)
        self.queue.push(req)

    def slo_summary(self) -> SLOSummary:
        """TTFT / time-between-tokens / e2e percentiles of retired requests
        (empty unless constructed with an enabled Telemetry), computed at
        read time, never per retire."""
        if self._slo is None:
            return SLOSummary()
        s = self._slo.summary()
        st = self.stats
        st.ttft_p50_s, st.ttft_p99_s = s.ttft_p50_s, s.ttft_p99_s
        st.tbt_p50_s, st.tbt_p99_s = s.tbt_p50_s, s.tbt_p99_s
        st.e2e_p50_s, st.e2e_p99_s = s.e2e_p50_s, s.e2e_p99_s
        if self.meter is not None:
            attach_energy_percentiles(s, self.meter.request_energy_j(),
                                      self._tokens_by_rid)
        return s

    def run(self, max_steps: int = 10_000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                break
            self._admit(done)
            self._step(done)
        if self._slo is not None:
            self.slo_summary()           # refresh stats percentiles once
        return done

    def occupancy_bundle(self) -> TraceBundle:
        """The Stage-II view of this serving run: feed to explorer.sweep()."""
        if self.cfg is None:
            raise ValueError("model carries no ArchConfig; no trace emitted")
        return TraceBundle(graph_name=f"{self.cfg.name}-serve",
                           total_time=max(self._sim_t, self.step_time_s),
                           traces={"kv": self.trace}, access=self.access)

    # ------------------------------------------------------------- internals
    def _retire(self, i: int, req: Request, done: List[Request]) -> None:
        req.finished_wall_s = time.perf_counter()
        req.finished_s = self._sim_t
        done.append(req)
        self.slots[i] = None
        self._caches[i] = None
        self._next_tok[i] = None
        self.stats.finished += 1
        if self._slot_bytes[i]:
            self.trace.event(self._sim_t, -self._slot_bytes[i], 0)
            if self.meter is not None:
                self.meter.record(self._sim_t, -self._slot_bytes[i], 0,
                                  rid=req.rid, tenant=req.tenant)
            self.stats.retired_kv_bytes += self._slot_bytes[i]
        self._slot_bytes[i] = 0
        self._slot_ctx[i] = 0
        if self.meter is not None:
            self._tokens_by_rid[req.rid] = len(req.output)
            if req.timeline is not None:
                req.timeline.energy_j = self.meter.request_energy_live(
                    req.rid)
        if self.tel.enabled:
            self.tel.counter("serve.dense.retired").inc()
            tl = req.timeline
            if tl is not None:
                tl.finish_t = self._sim_t
                self._slo.observe(tl)
                self.tel.add_span("request", tl.submit_t, self._sim_t,
                                  rid=req.rid, tokens=len(req.output))

    def _admit(self, done: List[Request]) -> None:
        dev = self.model.device
        for i in range(self.num_slots):
            if self.slots[i] is not None or not self.queue:
                continue
            req = self.queue.pop()
            t_pre = self._sim_t
            tokens = torch.as_tensor(np.asarray(req.tokens)[None, :],
                                     dtype=torch.long, device=dev)
            logits, cache = self.model.prefill(self.params,
                                               {"tokens": tokens},
                                               self.max_len)
            tok = int(torch.argmax(logits[0, -1]))
            self.slots[i] = req
            self._caches[i] = cache
            self._next_tok[i] = tok
            req.output.append(tok)
            self.stats.admitted += 1
            self.stats.prefills += 1
            self.stats.peak_active_slots = max(
                self.stats.peak_active_slots,
                sum(s is not None for s in self.slots))
            # trace: the prefill writes the whole prompt's KV into the slot
            ctx = int(len(req.tokens))
            self._sim_t += ctx * self.prefill_tok_s
            if self.cfg is not None:
                b = (kv_bytes_at(self.cfg, ctx, self.kv_dtype_bytes)
                     + slot_state_bytes(self.cfg))
                self._slot_bytes[i] = b
                self._slot_ctx[i] = ctx
                self.trace.event(self._sim_t, b, 0)
                if self.meter is not None:
                    self.meter.record(self._sim_t, b, 0, rid=req.rid,
                                      tenant=req.tenant, cause="admission")
                self.access.add_write("kv", b)
                self.stats.admitted_kv_bytes += b
            if self.tel.enabled:
                self.tel.counter("serve.dense.admitted").inc()
                self.tel.counter("serve.dense.prefills").inc()
                self.tel.add_span("prefill", t_pre, self._sim_t,
                                  slot=i, rid=req.rid, tokens=ctx)
                tl = req.timeline
                if tl is not None:
                    tl.admit_t = t_pre
                    tl.first_token_t = self._sim_t
                    tl.token_ts.append(self._sim_t)
            # the prefill already produced the first new token: retire now
            # if it satisfies the request
            if (req.max_new_tokens <= 1
                    or (req.eos_id is not None and tok == req.eos_id)):
                self._retire(i, req, done)

    def _step(self, done: List[Request]) -> None:
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return
        self._sim_t += self.step_time_s
        dev = self.model.device
        for i in active:
            req = self.slots[i]
            tok = torch.tensor([[self._next_tok[i]]], dtype=torch.long,
                               device=dev)
            logits, self._caches[i] = self.model.decode_step(
                self.params, self._caches[i], tok)
            nxt = int(torch.argmax(logits[0, -1]))
            req.output.append(nxt)
            self._next_tok[i] = nxt
            self.stats.decode_steps += 1
            if self.tel.enabled:
                self.tel.counter("serve.dense.decode_steps").inc()
                if req.timeline is not None:
                    req.timeline.token_ts.append(self._sim_t)
            if self.cfg is not None:
                # attention reads the whole resident KV, then appends one
                # row (the bounded cache stops growing at max_len)
                ctx = self._slot_ctx[i]
                self.access.add_read("kv", self._slot_bytes[i])
                nxt_ctx = min(ctx + 1, self.max_len)
                d = (kv_bytes_at(self.cfg, nxt_ctx, self.kv_dtype_bytes)
                     - kv_bytes_at(self.cfg, ctx, self.kv_dtype_bytes))
                self._slot_ctx[i] = nxt_ctx
                if d:
                    self._slot_bytes[i] += d
                    self.trace.event(self._sim_t, d, 0)
                    if self.meter is not None:
                        self.meter.record(self._sim_t, d, 0, rid=req.rid,
                                          tenant=req.tenant,
                                          cause="decode_growth")
                    self.access.add_write("kv", d)
                    self.stats.admitted_kv_bytes += d
            hit_eos = req.eos_id is not None and nxt == req.eos_id
            if hit_eos or len(req.output) >= req.max_new_tokens:
                self._retire(i, req, done)
