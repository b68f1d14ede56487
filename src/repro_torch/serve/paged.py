"""Paged KV-cache serving of the port: free-list page allocator, page ledger
and a continuous batcher whose decode loop stays on the device (port of the
reference's `repro/serve/paged.py`, plain path).

  * `PageAllocator` — host-side LIFO free list over the global page pool
    (page 0 is the null page inactive slots point at);
  * `PagedKVLedger` — page accounting + page-granular `OccupancyTrace`
    emission (alloc/free events integrate to zero at drain; occupancy is
    always pages x page_bytes);
  * `PagedContinuousBatcher` — continuous batching where admission prefills
    a prompt once and scatters its KV rows into fresh pages, and decode
    advances every slot `chunk_steps` tokens per host round trip.

Ported: plain admission, the decode chunk, `occupancy_bundle`, quantized
page pools (`kv_dtype` native/fp32/bf16/fp16/int8/fp8, pages priced by
`page_bytes` with int8's scales), `collect_logits`, speculative decoding
(`speculate_k`: a draft page lane on the same allocator, draft rounds
verified by `DecoderLM.verify_step_paged`, rollback by page truncation),
prefix sharing (`prefix_cache`: `serve.prefix`'s radix index, refcounted
COW pages and dual traces), chunked prefill (`prefill_chunk_tokens`),
priority admission with preemption, `on_long_prompt`, and the
instrumentation: `telemetry=` (the `serve.paged.*` counters and gauges,
spans and per-request SLO timelines on the logical clock, `slo_summary()`)
and `meter=` (a streaming `obs.energy.BankEnergyMeter` fed by the ledger).
While a torch profiler runs, `obs.host_spans` times the host's side on
the wall clock: each admission, each decode chunk, the page writes, and
the host's reads of device data (`paged.sync`), where it waits on the
card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.quant import kv_dtype_spec
from repro_torch.models.transformer import (
    _require_pure_full, copy_pages, gather_prefix_pages, init_paged_cache,
    prefix_tail_rows, self_spec_draft, write_prefill_to_pages,
    write_shared_prefill_to_pages)
from repro_torch.obs.host_spans import host_span
from repro_torch.obs.slo import (RequestTimeline, SLOSummary, SLOTracker,
                                 attach_energy_percentiles)
from repro_torch.obs.telemetry import noop_registry
from repro_torch.serve.scheduler import AdmissionQueue, Request, SchedulerStats
from repro_torch.sim.trace import AccessStats, OccupancyTrace, TraceBundle


class OutOfPages(RuntimeError):
    """The page pool cannot cover a request's worst-case page demand."""


def page_bytes(cfg, page_size: int, kv_dtype_bytes: int = 2,
               scale_bytes_per_row: int = 0) -> int:
    """Bytes one KV page pins across all full-attention layers (K + V).

    `scale_bytes_per_row` adds the per-(token row, KV head) quantization
    scale (4 for int8's float32 per-row scales, 0 for float and scale-free
    fp8 pools), so quantized ledgers account the true physical footprint."""
    n_full = sum(1 for k in cfg.layer_kinds() if k == "full")
    b = n_full * 2 * page_size * cfg.kv_dim * kv_dtype_bytes
    if scale_bytes_per_row:
        b += n_full * 2 * page_size * cfg.num_kv_heads * scale_bytes_per_row
    return b


def pages_for(tokens: int, page_size: int) -> int:
    return max(0, -(-tokens // page_size))


class PageAllocator:
    """LIFO free-list allocator over `num_pages` pages; page 0 is the
    reserved null page and is never handed out."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the null page)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._allocated: set = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_allocated(self) -> int:
        return len(self._allocated)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise OutOfPages(f"requested {n} pages, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        self._allocated.update(out)
        return out

    def free(self, pages) -> None:
        for p in pages:
            if p not in self._allocated:
                raise ValueError(f"double free / foreign page {p}")
            self._allocated.remove(p)
            self._free.append(p)


class PagedKVLedger:
    """Per-slot page ownership + page-granular occupancy trace.

    Every `admit`/`grow` emits a positive delta of n_pages x page_bytes on
    the trace at the given logical time, every `retire` the matching
    negative delta, so the integrated trace equals the allocator's
    outstanding pages at all times and drains to zero.

    Speculative decoding adds a draft lane: per-slot private pages from the
    same allocator and page-id space, priced at the draft model's page
    bytes (`enable_draft_lane`). `truncate_rows` rolls both lanes back to
    an accepted context, emitting negative deltas mid-stream."""

    def __init__(self, num_pages: int, page_bytes_: int,
                 page_size: Optional[int] = None):
        self.allocator = PageAllocator(num_pages)
        self.page_bytes = page_bytes_
        self.page_size = page_size
        self.trace = OccupancyTrace("kv", (num_pages - 1) * page_bytes_)
        self.slot_pages: Dict[int, List[int]] = {}
        self.draft_pages: Dict[int, List[int]] = {}
        # draft pages are priced like target pages until enable_draft_lane
        self.draft_page_bytes = page_bytes_
        # optional streaming energy meter (obs.energy.BankEnergyMeter):
        # every trace delta is mirrored to it, tagged with the slot's
        # request/tenant and the ledger verb that caused it
        self.meter = None
        self.slot_meta: Dict[int, tuple] = {}

    def set_slot_meta(self, slot: int, rid, tenant=None) -> None:
        """Tag a slot so mirrored meter events attribute to its request."""
        self.slot_meta[slot] = (rid, tenant)

    def _mark(self, t: float, delta: int, slot: int,
              cause: Optional[str]) -> None:
        self.trace.event(t, delta, 0)
        if self.meter is not None:
            rid, tenant = self.slot_meta.get(slot, (None, None))
            self.meter.record(t, delta, 0, rid=rid, tenant=tenant,
                              cause=cause)

    def occupancy_bytes(self) -> int:
        nd = sum(len(p) for p in self.draft_pages.values())
        return ((self.allocator.n_allocated - nd) * self.page_bytes
                + nd * self.draft_page_bytes)

    def logical_bytes(self) -> int:
        """Without sharing, logical (per-slot demand) == physical bytes."""
        return self.occupancy_bytes()

    def admit(self, slot: int, n_pages: int, t: float) -> List[int]:
        if slot in self.slot_pages:
            raise ValueError(f"slot {slot} already admitted")
        pages = self.allocator.alloc(n_pages)
        self.slot_pages[slot] = list(pages)
        if n_pages:
            self._mark(t, n_pages * self.page_bytes, slot, "admission")
        return pages

    def grow(self, slot: int, total_pages: int, t: float,
             cause: str = "decode_growth") -> List[int]:
        """Extend the slot to `total_pages`; `cause` ("decode_growth", or
        "admission" for a chunked-prefill slice) tags the meter's event."""
        have = self.slot_pages[slot]
        extra = total_pages - len(have)
        if extra <= 0:
            return []
        pages = self.allocator.alloc(extra)
        have.extend(pages)
        self._mark(t, extra * self.page_bytes, slot, cause)
        return pages

    def retire(self, slot: int, t: float) -> int:
        """Free the slot's pages in both lanes; returns how many."""
        pages = self.slot_pages.pop(slot)
        self.allocator.free(pages)
        if pages:
            self._mark(t, -len(pages) * self.page_bytes, slot, None)
        dpages = self.draft_pages.pop(slot, [])
        if dpages:
            self.allocator.free(dpages)
            self._mark(t, -len(dpages) * self.draft_page_bytes, slot, None)
        self.slot_meta.pop(slot, None)
        return len(pages) + len(dpages)

    # ------------------------------------------------- speculative draft lane
    def enable_draft_lane(self, draft_page_bytes: int) -> None:
        """Declare the byte width of draft-lane pages (the draft model's
        per-page KV footprint)."""
        self.draft_page_bytes = int(draft_page_bytes)

    def admit_draft(self, slot: int, n_pages: int, t: float) -> List[int]:
        if slot in self.draft_pages:
            raise ValueError(f"slot {slot} already has a draft lane")
        pages = self.allocator.alloc(n_pages)
        self.draft_pages[slot] = list(pages)
        if n_pages:
            self._mark(t, n_pages * self.draft_page_bytes, slot, "admission")
        return pages

    def grow_draft(self, slot: int, total_pages: int, t: float) -> List[int]:
        have = self.draft_pages[slot]
        extra = total_pages - len(have)
        if extra <= 0:
            return []
        pages = self.allocator.alloc(extra)
        have.extend(pages)
        self._mark(t, extra * self.draft_page_bytes, slot, "decode_growth")
        return pages

    def truncate_rows(self, slot: int, n_rows: int,
                      t: float) -> Tuple[List[int], List[int]]:
        """Rollback by page truncation: free every page past
        `pages_for(n_rows)` in both lanes (target + draft), each lane's
        negative delta at `t`. Returns the (target, draft) pages freed."""
        if self.page_size is None:
            raise ValueError("truncate_rows needs a ledger page_size")
        keep = pages_for(n_rows, self.page_size)
        freed_t: List[int] = []
        have = self.slot_pages[slot]
        if keep < len(have):
            freed_t = have[keep:]
            del have[keep:]
            self.allocator.free(freed_t)
            self._mark(t, -len(freed_t) * self.page_bytes, slot,
                       "spec_rollback")
        freed_d: List[int] = []
        dhave = self.draft_pages.get(slot)
        if dhave is not None and keep < len(dhave):
            freed_d = dhave[keep:]
            del dhave[keep:]
            self.allocator.free(freed_d)
            self._mark(t, -len(freed_d) * self.draft_page_bytes, slot,
                       "spec_rollback")
        return freed_t, freed_d


@dataclass
class PagedStats(SchedulerStats):
    pages_allocated: int = 0
    pages_freed: int = 0
    peak_pages: int = 0
    chunks: int = 0
    # prefix-sharing counters (stay zero without prefix_cache)
    cow_splits: int = 0
    evicted_pages: int = 0
    # chunked-prefill slices executed (zero without prefill_chunk_tokens)
    prefill_slices: int = 0
    # speculative-decoding counters (stay zero without speculate_k)
    spec_rounds: int = 0
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    rolled_back_pages: int = 0


class PagedContinuousBatcher:
    """Priority continuous batching over a paged KV cache.

    Admission pops the highest-priority queued request (FIFO within a
    class) when a slot is free and the pool can cover its worst-case pages
    (prompt + max_new_tokens), prefills the prompt once (batch=1) and
    scatters its KV rows into freshly allocated pages; older slots are never
    touched. When the head would otherwise wait (no free slot, or too few
    pages) it may preempt strictly-lower-priority slots: the victim's pages
    free through the retire path, its partial output is discarded, and it
    requeues behind its own class for a re-prefill from scratch. Equal
    priorities never preempt each other. Decode runs in chunks of
    `chunk_steps` device steps: the liveness mask, remaining budgets and
    EOS checks stay on the device, and the host syncs once per chunk to
    collect tokens, retire finished slots, free their pages and admit
    queued requests.

    `kv_dtype` selects the page storage (`kernels.quant.kv_dtype_spec`):
    the model dtype ("native"), another float dtype, fp8 E4M3 codes, or
    int8 with per-row scales, decoded through `paged_gqa_decode_quant`.
    With `collect_logits` every request also keeps the last-position logits
    of its prefill and of each decode step (`Request.logits`, float32).
    `on_long_prompt="truncate"` cuts a prompt to what its slot table can
    hold beside its decode budget; "reject" raises `OutOfPages` at submit.

    Prefix sharing (`prefix_cache=True`): admission probes a
    `RadixPrefixIndex` with the prompt, maps the matched pages read-only
    into the slot's table, runs a suffix-only prefill against the gathered
    prefix KV (`DecoderLM.prefill_shared`, the prefill kernel with a query
    offset) and caches every admitted run for later requests. The last page
    of a shared run is copy-on-write split on the first divergent write;
    unreferenced cached prefixes are LRU-evicted under page pressure. The
    ledger then emits two Stage-I traces, "kv" (physical: unique referenced
    pages, cache-resident pages as obsolete) and "kv_logical" (the per-slot
    demand a non-sharing allocator would pin).

    Chunked prefill (`prefill_chunk_tokens`, a multiple of `page_size`):
    prompts longer than the chunk admit in page-aligned slices with one
    decode chunk for the other slots between slices. Slice 0 is a plain
    prefill; every later slice gathers the slot's own pages and runs the
    shared prefill. On a prefix hit only the suffix is sliced, the first
    slice sized to re-align a mid-page match boundary.

    Speculative decoding (`speculate_k`, greedy only): a draft model
    proposes `speculate_k` tokens per round through its own draft page lane
    (same allocator and page-id space, the draft's page bytes), the target
    scores the pending token plus all candidates in one
    `verify_step_paged` call, and the longest target-agreeing prefix is
    accepted. Every emitted token is the target's argmax, so the tokens
    equal the non-speculative loop's; the draft moves only the acceptance
    rate. Rejected suffixes roll back by page truncation at chunk
    boundaries (`PagedKVLedger.truncate_rows`), the negative mid-stream
    deltas of the occupancy trace. Without `draft_model` the draft is
    `self_spec_draft(model, params, skip=2)`. With `prefix_cache` the
    draft lane never shares: a hit only shortens the target's prefill.

    Emits the Stage-I artifact at page granularity: `occupancy_bundle()` is
    a `TraceBundle` whose "kv" trace steps in units of `page_bytes`, fed to
    `core.explorer.sweep` unchanged. Times on it are logical (`step_time_s`
    per decode step, `prefill_tok_s` per prefilled token), as in the
    reference, so the trace does not depend on the device's speed.

    Instrumentation only observes. An enabled `telemetry` registry has its
    clock bound to that logical clock (a second owner raises): its counters
    mirror `PagedStats`, its spans (request, decode, prefill,
    prefill_slice, preempt, cow, decode_chunk) and each request's
    `Request.timeline` are on the trace's time base, and `slo_summary()`
    reads TTFT / TBT / e2e percentiles from them. A `meter` rides the
    ledger: every page event is mirrored to it, tagged with the slot's
    request and tenant and the verb that caused it.
    """

    def __init__(self, model, params, *, num_slots: int = 4,
                 page_size: int = 16, num_pages: int = 64,
                 max_pages_per_slot: Optional[int] = None,
                 chunk_steps: int = 16, step_time_s: float = 1e-3,
                 prefill_tok_s: float = 5e-5, prefix_cache: bool = False,
                 collect_logits: bool = False, kv_dtype: str = "native",
                 prefill_chunk_tokens: Optional[int] = None,
                 on_long_prompt: str = "reject",
                 speculate_k: Optional[int] = None, draft_model=None,
                 draft_params=None, telemetry=None, meter=None):
        if not hasattr(model, "decode_step_paged"):
            raise TypeError("model lacks a paged decode path")
        if on_long_prompt not in ("reject", "truncate"):
            raise ValueError("on_long_prompt must be 'reject' or 'truncate'")
        if prefill_chunk_tokens is not None:
            if prefill_chunk_tokens < page_size or \
                    prefill_chunk_tokens % page_size:
                raise ValueError(
                    "prefill_chunk_tokens must be a positive multiple of "
                    f"page_size={page_size} so every slice boundary is "
                    "page-aligned (the chained slice prefill gathers whole "
                    f"pages); got {prefill_chunk_tokens}")
        if speculate_k is not None:
            if speculate_k < 1:
                raise ValueError(f"speculate_k must be >= 1, got "
                                 f"{speculate_k}")
            if collect_logits:
                raise NotImplementedError(
                    "collect_logits emits one logits row per decode step; "
                    "the speculative loop emits V verify rows per round "
                    "(rejected rows included) — use the non-speculative "
                    "loop for logits-level debugging")
            if kv_dtype == "int8":
                raise NotImplementedError(
                    "speculative verify scatters V rows per slot; the int8 "
                    "page pool's per-row requantization under that scatter "
                    "is not wired up (fp8/native pools are)")
            if (draft_model is None) != (draft_params is None):
                raise ValueError("pass draft_model and draft_params "
                                 "together (or neither for self-spec)")
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.device = model.device
        self.num_slots = num_slots
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages_per_slot = max_pages_per_slot or \
            max(1, (num_pages - 1) // max(1, num_slots))
        self.chunk_steps = chunk_steps
        self.step_time_s = step_time_s
        self.prefill_tok_s = prefill_tok_s
        self.prefix_cache = prefix_cache
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.on_long_prompt = on_long_prompt
        self.speculate_k = speculate_k

        # spans and SLOs record on the batcher's logical sim clock, the time
        # base of the ledger's occupancy trace, so a passed-in registry has
        # its clock bound here (the Perfetto export then shows request spans
        # and the KV counter track on one timeline); bind_clock raises if
        # another engine already owns the registry's clock
        self.tel = telemetry if telemetry is not None else noop_registry()
        if telemetry is not None:
            telemetry.bind_clock(lambda: self._sim_t, owner=self)
        tel = self.tel
        self._slo = (SLOTracker(tel, "serve.paged") if tel.enabled else None)
        self._c_admitted = tel.counter("serve.paged.admitted")
        self._c_retired = tel.counter("serve.paged.retired")
        self._c_prefills = tel.counter("serve.paged.prefills")
        self._c_chunks = tel.counter("serve.paged.chunks")
        self._c_steps = tel.counter("serve.paged.decode_steps")
        self._c_alloc = tel.counter("serve.paged.pages_allocated")
        self._c_freed = tel.counter("serve.paged.pages_freed")
        self._c_evicted = tel.counter("serve.paged.pages_evicted")
        self._c_cow = tel.counter("serve.paged.cow_splits")
        self._c_hits = tel.counter("serve.paged.prefix_hits")
        self._c_miss = tel.counter("serve.paged.prefix_misses")
        self._c_reused = tel.counter("serve.paged.prefix_tokens_reused")
        self._c_wait = tel.counter("serve.paged.backpressure_waits")
        self._c_preempt = tel.counter("serve.paged.preemptions")
        self._c_slices = tel.counter("serve.paged.prefill_slices")
        self._c_spec_rounds = tel.counter("serve.paged.spec_rounds")
        self._c_drafted = tel.counter("serve.paged.spec_drafted")
        self._c_accepted = tel.counter("serve.paged.spec_accepted")
        self._c_rollback = tel.counter("serve.paged.spec_rolled_back_pages")
        self._c_dequant = tel.counter("quant.dequant_pages")
        self._g_pages = tel.gauge("serve.paged.pages_in_use")
        self._g_kv_phys = tel.gauge("serve.paged.kv_bytes_physical")
        self._g_kv_logical = tel.gauge("serve.paged.kv_bytes_logical")

        self.collect_logits = collect_logits
        kv_spec = kv_dtype_spec(kv_dtype, native=model.compute_dtype)
        self.kv_dtype = kv_spec.name
        self.kv_quantized = kv_spec.quantized
        self.page_bytes = page_bytes(self.cfg, page_size, kv_spec.itemsize,
                                     kv_spec.scale_bytes_per_row)
        self.row_bytes = self.page_bytes // page_size
        if prefix_cache:
            from repro_torch.serve.prefix import SharedKVLedger
            self.ledger = SharedKVLedger(
                num_pages, self.page_bytes, page_size, num_slots=num_slots,
                max_pages_per_slot=self.max_pages_per_slot, telemetry=tel)
        else:
            self.ledger = PagedKVLedger(num_pages, self.page_bytes,
                                        page_size)
        # optional streaming BankEnergyMeter: rides the ledger, so every page
        # event is mirrored on the same sim clock, tagged with the causing
        # request; the batcher only supplies slot -> request metadata
        self.meter = meter
        self.ledger.meter = meter
        self.access = AccessStats()
        self.stats = PagedStats()

        self.queue = AdmissionQueue()
        self.slots: List[Optional[Request]] = [None] * num_slots
        self._tokens_by_rid: Dict[int, int] = {}   # retired, for J/token
        self._reserved = [0] * num_slots        # worst-case pages not yet held
        self._ctx = np.zeros(num_slots, np.int64)
        self._next_tok = np.zeros(num_slots, np.int64)
        self._table = np.zeros((num_slots, self.max_pages_per_slot), np.int32)
        self._sim_t = 0.0
        self._cache = init_paged_cache(
            self.cfg, num_slots, num_pages, page_size,
            self.max_pages_per_slot, dtype=model.compute_dtype,
            device=self.device, kv_dtype=self.kv_dtype)
        if prefix_cache or prefill_chunk_tokens is not None:
            _require_pure_full(self.cfg, "prefix_cache" if prefix_cache
                               else "prefill_chunk_tokens")
            # the reference's fixed attention width (its slot capacity);
            # the port's kernel does not need it (`prefill_shared`)
            self._pad_to = self.max_pages_per_slot * page_size
        if speculate_k is not None:
            _require_pure_full(self.cfg, "speculate_k")
            if draft_model is None:
                draft_model, draft_params = self_spec_draft(model, params,
                                                            skip=2)
            self.draft_model = draft_model
            self.draft_params = draft_params
            dcfg = draft_model.cfg
            self.draft_page_bytes = page_bytes(dcfg, page_size,
                                               kv_spec.itemsize,
                                               kv_spec.scale_bytes_per_row)
            self.draft_row_bytes = self.draft_page_bytes // page_size
            self.ledger.enable_draft_lane(self.draft_page_bytes)
            self._draft_table = np.zeros(
                (num_slots, self.max_pages_per_slot), np.int32)
            # the draft lane's pools are indexed by the same page ids as the
            # target's (one allocator), so they span the whole pool too, at
            # the draft's depth
            self._draft_cache = init_paged_cache(
                dcfg, num_slots, num_pages, page_size,
                self.max_pages_per_slot, dtype=draft_model.compute_dtype,
                device=self.device, kv_dtype=self.kv_dtype)
            self.spec_rounds_per_chunk = max(
                1, chunk_steps // (speculate_k + 1))
            # sim-clock cost of one draft-then-verify round vs one plain
            # decode step: the batched verify streams the target's weights
            # once (about one step), plus k + 1 sequential draft steps at
            # the draft's layer fraction
            self.draft_cost_frac = (dcfg.num_layers
                                    / max(1, self.cfg.num_layers))
            self.spec_round_time_s = step_time_s * (
                1.0 + (speculate_k + 1) * self.draft_cost_frac)

    # ------------------------------------------------------------ client API
    def submit(self, req: Request) -> None:
        S = int(len(req.tokens))
        cap = self.max_pages_per_slot * self.page_size
        # speculation writes up to V - 1 = speculate_k rows past the final
        # accepted context before the last rollback truncates them
        spec_extra = (self.speculate_k if self.speculate_k is not None
                      and req.max_new_tokens > 1 else 0)
        if S + max(req.max_new_tokens - 1, 0) + spec_extra > cap \
                and self.on_long_prompt == "truncate":
            # keep the decode budget, give the prompt whatever table
            # capacity remains (mirrors the dense batcher's max_len cut)
            keep = cap - max(req.max_new_tokens - 1, 0) - spec_extra
            if keep >= 1:
                req.tokens = np.asarray(req.tokens)[:keep]
                S = keep
        worst = self._worst_pages(S, req.max_new_tokens)
        # speculation doubles the lanes: the draft mirrors the target's page
        # demand row for row (same page_size, its own page_bytes). Prefix
        # mode keeps one more pool page back for the deferred COW split of
        # a mid-page prompt boundary: it never takes a table entry (COW
        # swaps one in place), but it must fit the pool, or admission could
        # wait forever on a demand no drain can meet
        pool_worst = worst * self._lanes + (
            1 if self.prefix_cache and S % self.page_size
            and req.max_new_tokens > 1 else 0)
        if worst > self.max_pages_per_slot or pool_worst > self.num_pages - 1:
            raise OutOfPages(
                f"request {req.rid} needs {worst} table / {pool_worst} pool "
                f"pages; slot tables hold {self.max_pages_per_slot}, pool "
                f"holds {self.num_pages - 1}")
        req.submitted_wall_s = time.perf_counter()
        req.submitted_s = self._sim_t
        if self.tel.enabled:
            req.timeline = RequestTimeline(rid=req.rid, submit_t=self._sim_t)
        self.queue.push(req)

    def run(self, max_chunks: int = 10_000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_chunks):
            if not self.queue and all(s is None for s in self.slots):
                break
            self._admit(done)
            self._decode_chunk(done)
        if self._slo is not None:
            self.slo_summary()           # refresh stats percentiles once
        return done

    def slo_summary(self) -> SLOSummary:
        """Percentiles of per-request TTFT / TBT / e2e on the sim clock
        (zeros when the batcher runs without an enabled registry), computed
        here, at read time, never inside the decode loop."""
        if self._slo is None:
            return SLOSummary()
        s = self._slo.summary()
        # bytes-based physical occupancy (pages x quantized page_bytes) next
        # to the latency percentiles
        s.kv_peak_bytes = float(self.ledger.trace.peak_needed())
        s.kv_mean_bytes = float(self.ledger.trace.time_weighted_mean(
            max(self._sim_t, self.step_time_s)))
        st = self.stats
        st.ttft_p50_s, st.ttft_p99_s = s.ttft_p50_s, s.ttft_p99_s
        st.tbt_p50_s, st.tbt_p99_s = s.tbt_p50_s, s.tbt_p99_s
        st.e2e_p50_s, st.e2e_p99_s = s.e2e_p50_s, s.e2e_p99_s
        if self.meter is not None:
            attach_energy_percentiles(s, self.meter.request_energy_j(),
                                      self._tokens_by_rid)
        return s

    def occupancy_bundle(self) -> TraceBundle:
        """Page-granular Stage-II view: feed to explorer.sweep() unchanged.

        With `prefix_cache` the bundle carries both traces: "kv" is the
        physical occupancy (unique referenced pages as needed, cached pages
        as obsolete, what Stage II should gate against) and "kv_logical"
        the per-slot demand a non-sharing allocator would pin; their gap is
        the headroom sharing frees."""
        traces = {"kv": self.ledger.trace}
        name = f"{self.cfg.name}-paged-serve"
        if self.prefix_cache:
            traces["kv_logical"] = self.ledger.logical
            name = f"{self.cfg.name}-prefix-serve"
        return TraceBundle(graph_name=name,
                           total_time=max(self._sim_t, self.step_time_s),
                           traces=traces, access=self.access)

    # ------------------------------------------------------------- internals
    def _available_pages(self) -> int:
        return self.ledger.allocator.n_free - sum(self._reserved)

    def _worst_pages(self, S: int, max_new: int) -> int:
        """Worst-case page demand of one lane for a prompt of `S` tokens:
        prompt rows + decode rows + the up-to-`speculate_k` overshoot rows a
        verify window can write past the final accepted context."""
        extra = (self.speculate_k if self.speculate_k is not None
                 and max_new > 1 else 0)
        return pages_for(S + max(max_new - 1, 0) + extra, self.page_size)

    @property
    def _lanes(self) -> int:
        return 2 if self.speculate_k is not None else 1

    def _set_page_gauges(self) -> None:
        """Page-count and bytes gauges: physical = pool pages held x
        page_bytes (quantization shrinks page_bytes), logical = the per-slot
        demand a non-sharing allocator would pin."""
        n = self.ledger.allocator.n_allocated
        self._g_pages.set(n)
        self._g_kv_phys.set(n * self.page_bytes)
        self._g_kv_logical.set(self.ledger.logical_bytes())

    def _release_slot(self, i: int, t: float) -> int:
        """Free slot `i`'s pages (both lanes) and clear its host mirrors;
        shared by retirement and preemption. Returns the pages freed."""
        self.slots[i] = None
        n = self.ledger.retire(i, t)
        self.stats.pages_freed += n
        self.stats.retired_kv_bytes += n * self.page_bytes
        self._reserved[i] = 0
        self._ctx[i] = 0
        self._table[i, :] = 0
        if self.speculate_k is not None:
            self._draft_table[i, :] = 0
        return n

    def _retire(self, i: int, req: Request, done: List[Request],
                t: float) -> None:
        req.finished_wall_s = time.perf_counter()
        req.finished_s = t
        done.append(req)
        n = self._release_slot(i, t)
        self.stats.finished += 1
        self._c_retired.inc()
        self._c_freed.inc(n)
        self._set_page_gauges()
        if self.meter is not None:
            self._tokens_by_rid[req.rid] = len(req.output)
        tl = req.timeline
        if tl is not None and self.meter is not None:
            # final at retire: the request holds no pages past this event,
            # so no later charge can land on it
            tl.energy_j = self.meter.request_energy_live(req.rid)
        if tl is not None and self._slo is not None:
            tl.finish_t = t
            self._slo.observe(tl)
            self.tel.add_span("request", tl.submit_t, t, rid=req.rid,
                              tokens=len(req.output))
            if np.isfinite(tl.first_token_t) and t > tl.first_token_t:
                self.tel.add_span("decode", tl.first_token_t, t, slot=i,
                                  rid=req.rid)

    def _preempt_victim(self, priority: int) -> Optional[int]:
        """The slot to evict for a `priority`-class admission: the
        lowest-priority active slot strictly below the admitting class
        (equal classes never preempt each other, so no livelock), least
        decode progress first within a class (least work discarded)."""
        best = None
        best_key = None
        for i, r in enumerate(self.slots):
            if r is None or r.priority >= priority:
                continue
            key = (r.priority, len(r.output))
            if best is None or key < best_key:
                best, best_key = i, key
        return best

    def _preempt(self, i: int, t: float) -> None:
        """Evict slot `i` and requeue its request. Pages return through the
        ordinary retire path (the occupancy trace stays conservative); the
        partial output is discarded and the prompt re-prefills from scratch
        on re-admission: a greedy restart reproduces the uncontended
        tokens, where resuming mid-decode would not (the prefill's
        reduction order differs from the decode kernel's)."""
        req = self.slots[i]
        req.output.clear()
        req.logits.clear()
        req.preemptions += 1
        n = self._release_slot(i, t)
        self.stats.preemptions += 1
        self._c_preempt.inc()
        self._c_freed.inc(n)
        self._set_page_gauges()
        if req.timeline is not None:
            req.timeline.reset_admission()
        if self.tel.enabled:
            self.tel.add_span("preempt", t, t, slot=i, rid=req.rid)
        self.queue.push(req)     # fresh seq: re-enters behind its own class

    def _preempt_for(self, priority: int, worst: int) -> bool:
        """Free pages for a `priority`-class admission by preempting
        strictly-lower-priority slots, lowest class / least progress first.
        Returns False when eligible victims run out before `worst` pages
        are coverable (the head then waits as before)."""
        while worst > self._available_pages():
            v = self._preempt_victim(priority)
            if v is None:
                return False
            self._preempt(v, self._sim_t)
        return True

    def _tokens(self, tokens: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens)[None, :], dtype=torch.long,
                               device=self.device)

    def _admit(self, done: List[Request]) -> None:
        with host_span("paged.admit"):
            self._admit_queue(done)

    def _admit_queue(self, done: List[Request]) -> None:
        while self.queue:
            i = next((k for k, s in enumerate(self.slots) if s is None), None)
            if i is None:
                # every slot is busy: a strictly-higher-priority head may
                # evict the lowest-priority slot instead of queueing
                v = self._preempt_victim(self.queue.peek().priority)
                if v is None:
                    break
                self._preempt(v, self._sim_t)
                continue
            if self.prefix_cache:
                if not self._admit_prefix(i, done):
                    break                  # wait for pages to free up
                continue
            req = self.queue.peek()
            prompt_len = int(len(req.tokens))
            worst = self._worst_pages(prompt_len, req.max_new_tokens) \
                * self._lanes
            if worst > self._available_pages() \
                    and not self._preempt_for(req.priority, worst):
                self._c_wait.inc()
                break                      # wait for pages to free up
            self.queue.pop()
            if (self.prefill_chunk_tokens is not None
                    and prompt_len > self.prefill_chunk_tokens):
                self._admit_chunked(i, req, done, worst)
                continue
            npg = pages_for(prompt_len, self.page_size)
            t_pre = self._sim_t
            logits, dense = self.model.prefill(
                self.params, {"tokens": self._tokens(req.tokens)},
                npg * self.page_size)
            with host_span("paged.sync", at="first_token"):
                tok = int(torch.argmax(logits[0, -1]))
            self._sim_t += prompt_len * self.prefill_tok_s
            if self.meter is not None:
                self.ledger.set_slot_meta(i, req.rid, req.tenant)
            pages = self.ledger.admit(i, npg, self._sim_t)
            self._reserved[i] = worst - npg
            self.stats.pages_allocated += npg
            self.stats.peak_pages = max(self.stats.peak_pages,
                                        self.ledger.allocator.n_allocated)
            self.stats.admitted_kv_bytes += npg * self.page_bytes
            self.access.add_write("kv", prompt_len * self.row_bytes)
            self._c_alloc.inc(npg)
            with host_span("paged.page_write"):
                write_prefill_to_pages(
                    self.cfg, self._cache, dense, i,
                    torch.as_tensor(pages, dtype=torch.int32))
            self._commit_admission(i, req, done, tok, logits, prompt_len,
                                   pages, t_pre)

    def _slice_prefill(self, i: int, tokens: np.ndarray, pos: int):
        """A later slice of a chunked admission: gather slot `i`'s own
        resident pages (its first `pos` rows, `pos` page-aligned), prefill
        `tokens` against them with the query offset `pos`, grow the slot by
        the pages the slice fills and write its KV there. Returns the
        logits and the number of fresh pages."""
        held = list(self.ledger.slot_pages[i])
        prefix = gather_prefix_pages(self.cfg, self._cache, held, pos)
        if self.kv_quantized:
            self._c_dequant.inc(len(held))
        head = prefix_tail_rows(prefix, 0)          # pos is page-aligned
        logits, suffix = self.model.prefill_shared(
            self.params, {"tokens": self._tokens(tokens)}, prefix,
            pad_to=self._pad_to)
        self._sim_t += len(tokens) * self.prefill_tok_s
        fresh = self.ledger.grow(i, pages_for(pos + len(tokens),
                                              self.page_size),
                                 self._sim_t, cause="admission")
        self._reserved[i] -= len(fresh)
        with host_span("paged.page_write"):
            write_shared_prefill_to_pages(self.cfg, self._cache, suffix, head,
                                          i, held, fresh)
        return logits, len(fresh)

    def _count_slice(self, take: int, new_n: int) -> None:
        self.stats.pages_allocated += new_n
        self.stats.admitted_kv_bytes += new_n * self.page_bytes
        self.stats.peak_pages = max(self.stats.peak_pages,
                                    self.ledger.allocator.n_allocated)
        self.access.add_write("kv", take * self.row_bytes)
        self._c_alloc.inc(new_n)

    def _note_slice(self, i: int, req: Request, t0: float,
                    take: int) -> None:
        """Count one executed prefill slice of slot `i` and span it from
        `t0` to now."""
        self.stats.prefill_slices += 1
        self._c_slices.inc()
        if self.tel.enabled:
            self.tel.add_span("prefill_slice", t0, self._sim_t, slot=i,
                              rid=req.rid, tokens=take)

    def _admit_chunked(self, i: int, req: Request, done: List[Request],
                       worst: int) -> None:
        """Chunked prefill: admit `req` into slot `i` in page-aligned
        slices of `prefill_chunk_tokens`, running one decode chunk for the
        other active slots between consecutive slices, so a long prompt no
        longer stalls their token cadence. Slice 0 is a plain prefill;
        every later slice gathers the slot's own pages as a prefix and runs
        the shared prefill. The slot stays invisible to the decode loop
        (host `active` mask) until the last slice commits; the page
        reservation made up front keeps interleaved chunks from taking this
        slot's worst-case pages."""
        prompt = np.asarray(req.tokens)
        S = int(len(prompt))
        ps = self.page_size
        C = self.prefill_chunk_tokens
        t_pre = self._sim_t
        pos = 0
        logits = None
        while pos < S:
            take = min(C, S - pos)
            t0 = self._sim_t
            if pos == 0:
                new_n = pages_for(take, ps)
                logits, dense = self.model.prefill(
                    self.params, {"tokens": self._tokens(prompt[:take])},
                    new_n * ps)
                self._sim_t += take * self.prefill_tok_s
                if self.meter is not None:
                    self.ledger.set_slot_meta(i, req.rid, req.tenant)
                pages = self.ledger.admit(i, new_n, self._sim_t)
                self._reserved[i] = worst - new_n
                with host_span("paged.page_write"):
                    write_prefill_to_pages(
                        self.cfg, self._cache, dense, i,
                        torch.as_tensor(pages, dtype=torch.int32))
            else:
                logits, new_n = self._slice_prefill(
                    i, prompt[pos:pos + take], pos)
            self._count_slice(take, new_n)
            self._note_slice(i, req, t0, take)
            pos += take
            if pos < S:
                # let the active slots stream tokens before the next slice
                self._decode_chunk(done)
        with host_span("paged.sync", at="first_token"):
            tok = int(torch.argmax(logits[0, -1]))
        self._commit_admission(i, req, done, tok, logits, S,
                               self.ledger.slot_pages[i], t_pre)

    def _admit_prefix(self, i: int, done: List[Request]) -> bool:
        """Prefix-cache admission of the queue head into slot `i`.

        Returns False when the pool (after LRU-evicting cached prefixes and
        preempting strictly-lower-priority slots) still cannot cover the
        request's worst-case fresh page demand; the head then waits. The
        worst case reserves the pages the match did not cover, plus one
        page for the deferred COW split of a mid-page prompt boundary."""
        req = self.queue.peek()
        prompt = np.asarray(req.tokens)
        S = int(len(prompt))
        ps = self.page_size
        worst_total = self._worst_pages(S, req.max_new_tokens)
        cow_extra = 1 if (S % ps and req.max_new_tokens > 1) else 0
        # the draft lane never shares: a hit only shortens the target's
        # prefill, the draft's full worst case is fresh demand
        draft_extra = worst_total if self.speculate_k is not None else 0

        def demand(match):
            return (worst_total - len(match.pages) + cow_extra
                    + draft_extra)

        match = self.ledger.index.probe(prompt, limit=S - 1)
        short = demand(match) - self._available_pages()
        while short > 0:
            freed = self.ledger.evict_for(short, self._sim_t)
            if freed:
                self.stats.evicted_pages += freed
                self._c_evicted.inc(freed)
            else:
                # nothing cached left to drop: preempt a lower-priority
                # slot before giving up (pages free via the retire path)
                v = self._preempt_victim(req.priority)
                if v is None:
                    self._c_wait.inc()
                    return False
                self._preempt(v, self._sim_t)
            # eviction or preemption may have changed the matched path
            match = self.ledger.index.probe(prompt, limit=S - 1)
            short = demand(match) - self._available_pages()
        self.queue.pop()

        n_full, j = len(match.pages), match.tail_tokens
        m = n_full * ps + j
        t_pre = self._sim_t
        C = self.prefill_chunk_tokens
        suffix_len = S - m
        if C is not None and suffix_len > C:
            # chunk the suffix: slice 0 re-aligns the (possibly mid-page)
            # match boundary to a page multiple, so every later slice
            # boundary is page-aligned
            slices = [min(C - (m % ps), suffix_len)]
            while sum(slices) < suffix_len:
                slices.append(min(C, suffix_len - sum(slices)))
        else:
            slices = [suffix_len]

        pos = m
        logits = None
        for si, take in enumerate(slices):
            t0 = self._sim_t
            if si == 0:
                gather_ids = list(match.pages) + \
                    ([match.tail_page] if j else [])
                prefix = gather_prefix_pages(self.cfg, self._cache,
                                             gather_ids, m)
                if self.kv_quantized and gather_ids:
                    self._c_dequant.inc(len(gather_ids))
                head = prefix_tail_rows(prefix, j)
                logits, suffix = self.model.prefill_shared(
                    self.params, {"tokens": self._tokens(prompt[m:m + take])},
                    prefix, pad_to=self._pad_to)
                self._sim_t += take * self.prefill_tok_s  # suffix only
                new_n = pages_for(m + take, ps) - n_full
                if self.meter is not None:
                    self.ledger.set_slot_meta(i, req.rid, req.tenant)
                fresh = self.ledger.admit(i, new_n, self._sim_t,
                                          shared=match.pages)
                self._reserved[i] = demand(match) - new_n
                with host_span("paged.page_write"):
                    write_shared_prefill_to_pages(self.cfg, self._cache,
                                                  suffix, head, i,
                                                  match.pages, fresh)
            else:
                logits, new_n = self._slice_prefill(
                    i, prompt[pos:pos + take], pos)
            self._count_slice(take, new_n)
            if len(slices) > 1:
                self._note_slice(i, req, t0, take)
            pos += take
            if pos < S:
                # let the active slots stream tokens before the next slice
                self._decode_chunk(done)
        with host_span("paged.sync", at="first_token"):
            tok = int(torch.argmax(logits[0, -1]))
        if m:
            self.stats.prefix_hits += 1
            self.stats.prefix_tokens_reused += m
            self._c_hits.inc()
            self._c_reused.inc(m)
        else:
            self._c_miss.inc()
        # cache this run for later requests (the index refs its pages)
        self.ledger.insert_run(prompt, self.ledger.slot_pages[i], self._sim_t)
        self._commit_admission(i, req, done, tok, logits, S,
                               self.ledger.slot_pages[i], t_pre)
        return True

    def _commit_admission(self, i: int, req: Request, done: List[Request],
                          tok: int, logits: torch.Tensor, ctx: int,
                          table_pages: List[int], t_pre: float) -> None:
        """Host mirrors, stats, the prefill-produced first token, and the
        immediate retire when that token already satisfies the request.
        `t_pre` is the sim time before the prefill advance (the span
        start)."""
        self.slots[i] = req
        self._c_admitted.inc()
        self._c_prefills.inc()
        self._set_page_gauges()
        if self.tel.enabled:
            self.tel.add_span("prefill", t_pre, self._sim_t, slot=i,
                              rid=req.rid, tokens=ctx)
            tl = req.timeline
            if tl is not None:
                tl.admit_t = t_pre
                tl.first_token_t = self._sim_t
                tl.token_ts.append(self._sim_t)
        self._ctx[i] = ctx
        self._next_tok[i] = tok
        self._table[i, :] = 0
        self._table[i, :len(table_pages)] = table_pages
        req.output.append(tok)
        if self.collect_logits:
            with host_span("paged.sync", at="first_token"):
                req.logits.append(logits[0, -1].float().cpu().numpy())
        self.stats.admitted += 1
        self.stats.prefills += 1
        self.stats.peak_active_slots = max(
            self.stats.peak_active_slots,
            sum(s is not None for s in self.slots))
        if (req.max_new_tokens <= 1
                or (req.eos_id is not None and tok == req.eos_id)):
            self._retire(i, req, done, self._sim_t)
        elif self.speculate_k is not None:
            self._admit_draft_lane(i, req)

    def _admit_draft_lane(self, i: int, req: Request) -> None:
        """Prefill the draft model over the full prompt into the slot's
        draft page lane. The draft never shares pages (no radix entry, no
        COW): a prefix hit only shortens the target's prefill."""
        prompt = np.asarray(req.tokens)
        S = int(len(prompt))
        dn = pages_for(S, self.page_size)
        self._sim_t += S * self.prefill_tok_s * self.draft_cost_frac
        dpages = self.ledger.admit_draft(i, dn, self._sim_t)
        self._reserved[i] -= dn
        self._draft_table[i, :] = 0
        self._draft_table[i, :dn] = dpages
        _, ddense = self.draft_model.prefill(self.draft_params,
                                             {"tokens": self._tokens(prompt)},
                                             dn * self.page_size)
        write_prefill_to_pages(self.draft_model.cfg, self._draft_cache,
                               ddense, i,
                               torch.as_tensor(dpages, dtype=torch.int32))
        self.stats.pages_allocated += dn
        self.stats.peak_pages = max(self.stats.peak_pages,
                                    self.ledger.allocator.n_allocated)
        self.stats.admitted_kv_bytes += dn * self.draft_page_bytes
        self.access.add_write("kv", S * self.draft_row_bytes)
        self._c_alloc.inc(dn)
        self._set_page_gauges()

    def _cow_for_chunk(self, i: int, steps_i: int, t: float) -> None:
        """Copy-on-write split every shared page this chunk will write.

        Decode appends rows [ctx, ctx + steps_i); only the page holding the
        prompt's mid-page boundary can be shared (with the prefix index, or
        with slots that mapped the same run), so at most one split fires per
        slot, but the scan covers the whole range. The reservation made at
        admission covers the extra page, so `alloc` cannot fail."""
        ps = self.page_size
        ctx = int(self._ctx[i])
        pages = self.ledger.slot_pages[i]
        first, last = ctx // ps, (ctx + steps_i - 1) // ps
        for idx in range(first, min(last + 1, len(pages))):
            page = pages[idx]
            if self.ledger.allocator.refcount(page) <= 1:
                continue
            new = self.ledger.cow(i, idx, t)
            copy_pages(self.cfg, self._cache, page, new)
            self._table[i, idx] = new
            self._reserved[i] -= 1
            self.stats.cow_splits += 1
            self.stats.pages_allocated += 1
            self._c_cow.inc()
            self._c_alloc.inc()
            self.tel.add_span("cow", t, t, slot=i, page=new)

    def _decode_loop(self, tok: torch.Tensor, eos: torch.Tensor,
                     remaining: torch.Tensor):
        """Greedy `chunk_steps`-token decode for every slot, all on the
        device. Slots retire in-loop (EOS or token budget) through the
        cache's `active` mask; inactive lanes emit -1 and stop advancing.
        Returns one (chunk_steps + 2, num_slots) tensor: the emitted tokens,
        then the next input token and the liveness mask, so the host reads
        the chunk with a single copy; with `collect_logits`, also each
        step's last-position logits (chunk_steps, num_slots, V), else
        None."""
        cache = self._cache
        emitted = torch.empty((self.chunk_steps, self.num_slots),
                              dtype=torch.long, device=self.device)
        step_logits = []
        for s in range(self.chunk_steps):
            logits, cache = self.model.decode_step_paged(self.params, cache,
                                                         tok)
            if self.collect_logits:
                step_logits.append(logits[:, -1, :].float())
            active = cache["active"]
            # torch.argmax, like jnp.argmax, returns the first maximal index
            nxt = torch.argmax(logits[:, -1, :], dim=-1)
            emitted[s] = torch.where(active, nxt, -1)
            remaining = remaining - active.long()
            done = active & ((remaining <= 0) | ((eos >= 0) & (nxt == eos)))
            cache["active"] = active & ~done
            tok = torch.where(active[:, None], nxt[:, None], tok)
        out = torch.cat([emitted, tok[:, 0][None],
                         cache["active"].long()[None]])
        return out, (torch.stack(step_logits) if step_logits else None)

    def _grow(self, i: int, rows: int, t: float) -> None:
        """Grow slot `i`'s page table (and its draft lane, when speculating)
        to cover `rows` rows; the reservation made at admission guarantees
        these allocations succeed."""
        npg = pages_for(rows, self.page_size)
        lanes = [(self.ledger.grow, self.ledger.slot_pages, self._table,
                  self.page_bytes)]
        if self.speculate_k is not None:
            lanes.append((self.ledger.grow_draft, self.ledger.draft_pages,
                          self._draft_table, self.draft_page_bytes))
        for grow, held, table, nbytes in lanes:
            new_pages = grow(i, npg, t)
            if new_pages:
                have = len(held[i])
                table[i, have - len(new_pages):have] = new_pages
                self._reserved[i] -= len(new_pages)
                self.stats.pages_allocated += len(new_pages)
                self.stats.admitted_kv_bytes += len(new_pages) * nbytes
                self._c_alloc.inc(len(new_pages))

    def _push_host_state(self, cache: dict, table: np.ndarray) -> None:
        """The host is the source of truth between chunks: push a page-table
        mirror and the liveness mask to the device."""
        cache["page_table"] = torch.as_tensor(table, device=self.device)
        cache["active"] = torch.as_tensor(
            [s is not None for s in self.slots], device=self.device)

    def _eos_ids(self) -> torch.Tensor:
        return torch.as_tensor(
            [s.eos_id if s is not None and s.eos_id is not None else -1
             for s in self.slots], dtype=torch.long, device=self.device)

    def _decode_chunk(self, done: List[Request]) -> None:
        if self.speculate_k is not None:
            return self._spec_chunk(done)
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if not live:
            return
        with host_span("paged.decode_chunk", slots=len(live)):
            self._run_chunk(done, live)

    def _run_chunk(self, done: List[Request], live: List[int]) -> None:
        t0 = self._sim_t
        # grow page tables to cover this chunk's worst case
        remaining = np.zeros(self.num_slots, np.int64)
        for i in live:
            req = self.slots[i]
            remaining[i] = req.max_new_tokens - len(req.output)
            steps_i = min(self.chunk_steps, int(remaining[i]))
            self._grow(i, int(self._ctx[i]) + steps_i, t0)
            if self.prefix_cache:
                self._cow_for_chunk(i, steps_i, t0)
        self.stats.peak_pages = max(self.stats.peak_pages,
                                    self.ledger.allocator.n_allocated)

        dev = self.device
        self._push_host_state(self._cache, self._table)
        out, step_logits = self._decode_loop(
            torch.as_tensor(self._next_tok[:, None], device=dev),
            self._eos_ids(), torch.as_tensor(remaining, device=dev))
        with host_span("paged.sync", at="chunk"):
            out = out.cpu().numpy()
            if step_logits is not None:
                step_logits = step_logits.cpu().numpy()
        emitted = out[:self.chunk_steps]
        self._next_tok = out[self.chunk_steps].copy()
        still_active = out[self.chunk_steps + 1].astype(bool)
        self.stats.chunks += 1
        self._sim_t = t0 + self.chunk_steps * self.step_time_s
        self._c_chunks.inc()
        self.tel.add_span("decode_chunk", t0, self._sim_t, slots=len(live))

        for i in live:
            req = self.slots[i]
            col = emitted[:, i]
            neg = np.nonzero(col < 0)[0]
            g = int(neg[0]) if len(neg) else len(col)
            req.output.extend(int(t) for t in col[:g])
            if step_logits is not None:
                req.logits.extend(step_logits[:g, i])
            self.stats.decode_steps += g
            # page-granular access accounting: each step streams the resident
            # pages and appends one row
            ctxs = int(self._ctx[i]) + 1 + np.arange(g)
            pages_read = int((np.ceil(ctxs / self.page_size)).sum())
            self.access.add_read("kv", pages_read * self.page_bytes)
            self.access.add_write("kv", g * self.row_bytes)
            if self.kv_quantized and pages_read:
                # every page the fused kernel streams is dequantized in
                # registers
                self._c_dequant.inc(pages_read)
            self._c_steps.inc(g)
            if req.timeline is not None and g:
                req.timeline.token_ts.extend(
                    (t0 + self.step_time_s * np.arange(1, g + 1)).tolist())
            self._ctx[i] += g
            if not still_active[i]:
                self._retire(i, req, done, t0 + g * self.step_time_s)

    # ------------------------------------------------- speculative decoding
    def _spec_decode_loop(self, tok: torch.Tensor, eos: torch.Tensor,
                          remaining: torch.Tensor) -> torch.Tensor:
        """`spec_rounds_per_chunk` draft-then-verify rounds for every slot,
        all on the device. Each round the draft proposes `speculate_k`
        tokens (sequential decode steps over its own lane, plus a catch-up
        step that writes the last candidate's draft row), the target scores
        the pending token and every candidate in one `verify_step_paged`
        call, and the longest accepted prefix (clipped at EOS and at the
        token budget) advances both lanes' positions. Rejected rows stay
        past `pos` as garbage the next round overwrites before reading.

        Returns one long tensor: the accepted tokens (rounds, num_slots, V),
        -1 padded, flattened, then the next input token and the liveness
        mask, so the host reads the chunk with a single copy."""
        k = self.speculate_k
        V = k + 1
        cache, dcache = self._cache, self._draft_cache
        emitted = []
        col = torch.arange(V, device=self.device)[None, :]
        for _ in range(self.spec_rounds_per_chunk):
            active = cache["active"]
            pos0 = dcache["pos"]
            dtok = tok
            drafted = []
            for _ in range(k):
                dlogits, dcache = self.draft_model.decode_step_paged(
                    self.draft_params, dcache, dtok)
                nxt = torch.argmax(dlogits[:, -1, :], dim=-1)
                dtok = torch.where(active[:, None], nxt[:, None], dtok)
                drafted.append(nxt)
            # catch-up: write the last candidate's draft KV row so a fully
            # accepted round leaves no hole in the draft lane
            _, dcache = self.draft_model.decode_step_paged(
                self.draft_params, dcache, dtok)
            drafted = torch.stack(drafted, dim=1)              # (B, k)
            vlogits, cache = self.model.verify_step_paged(
                self.params, cache, torch.cat([tok, drafted], dim=1))
            g = torch.argmax(vlogits, dim=-1)                  # (B, V)
            # candidate v + 1 survives iff it equals the target's g_v
            match = (drafted == g[:, :k]).long()
            m_full = 1 + torch.cumprod(match, dim=1).sum(dim=1)  # in [1, V]
            eos_hit = (eos[:, None] >= 0) & (g == eos[:, None])
            # argmax returns the first maximal index, as jnp.argmax
            first_eos = torch.where(eos_hit.any(dim=1),
                                    torch.argmax(eos_hit.long(), dim=1), V)
            m = torch.minimum(torch.minimum(m_full, first_eos + 1),
                              remaining)
            m = torch.where(active, m, 0)
            emitted.append(torch.where(col < m[:, None], g, -1))
            new_tok = torch.gather(g, 1, (m - 1).clamp(min=0)[:, None])
            tok = torch.where(active[:, None], new_tok, tok)
            remaining = remaining - m
            eos_fired = eos_hit.any(dim=1) & (first_eos < m)
            done = active & ((remaining <= 0) | eos_fired)
            m32 = m.to(cache["pos"].dtype)
            cache["pos"] = cache["pos"] + m32
            dcache["pos"] = pos0 + m32        # rollback: rejected rows orphaned
            cache["active"] = active & ~done
            dcache["active"] = cache["active"]
        return torch.cat([torch.stack(emitted).reshape(-1), tok[:, 0],
                          cache["active"].long()])

    def _spec_chunk(self, done: List[Request]) -> None:
        """One speculative decode chunk: `spec_rounds_per_chunk` rounds for
        every live slot, then one host sync that harvests the accepted
        tokens and rolls both lanes back by page truncation: every page past
        the accepted context frees mid-stream and returns to the slot's
        reservation for later re-growth."""
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if not live:
            return
        t0 = self._sim_t
        k = self.speculate_k
        V = k + 1
        R = self.spec_rounds_per_chunk
        ps = self.page_size
        remaining = np.zeros(self.num_slots, np.int64)
        for i in live:
            req = self.slots[i]
            remaining[i] = req.max_new_tokens - len(req.output)
            # worst rows this chunk can touch: every round writes V rows at
            # pos .. pos + V - 1 and advances >= 1, and the last active round
            # starts with >= 1 token remaining
            rows = min(R * V, int(remaining[i]) + V - 1)
            self._grow(i, int(self._ctx[i]) + rows, t0)
            if self.prefix_cache:
                # the verify window writes past ctx: COW every shared page
                # in the whole speculative write range, not just chunk_steps
                self._cow_for_chunk(i, rows, t0)
        self.stats.peak_pages = max(self.stats.peak_pages,
                                    self.ledger.allocator.n_allocated)

        dev = self.device
        self._push_host_state(self._cache, self._table)
        self._push_host_state(self._draft_cache, self._draft_table)
        out = self._spec_decode_loop(
            torch.as_tensor(self._next_tok[:, None], device=dev),
            self._eos_ids(), torch.as_tensor(remaining, device=dev))
        out = out.cpu().numpy()
        n = R * self.num_slots * V
        emitted = out[:n].reshape(R, self.num_slots, V)
        self._next_tok = out[n:n + self.num_slots].copy()
        still_active = out[n + self.num_slots:].astype(bool)
        self.stats.chunks += 1
        self._sim_t = t0 + R * self.spec_round_time_s
        self._c_chunks.inc()
        self.tel.add_span("decode_chunk", t0, self._sim_t, slots=len(live))

        for i in live:
            req = self.slots[i]
            block = emitted[:, i, :]             # (rounds, V), -1 padded
            m_r = (block >= 0).sum(axis=1)       # per-round accepted count
            rounds_used = int((m_r > 0).sum())
            toks = block.ravel()
            toks = toks[toks >= 0]
            g = int(len(toks))
            req.output.extend(int(t) for t in toks)
            self.stats.decode_steps += g
            self.stats.spec_rounds += rounds_used
            self.stats.drafted_tokens += rounds_used * k
            self.stats.accepted_tokens += g
            self._c_spec_rounds.inc(rounds_used)
            self._c_drafted.inc(rounds_used * k)
            self._c_accepted.inc(g)
            # page-granular access accounting, per round: the verify kernel
            # streams the target's resident pages once; the draft streams
            # its own lane for each of its k + 1 sequential steps
            ctx = int(self._ctx[i])
            pos = ctx
            pages_t = 0
            pages_d = 0
            for r in range(rounds_used):
                per_round = -(-(pos + V) // ps)
                pages_t += per_round
                pages_d += (k + 1) * per_round
                pos += int(m_r[r])
            self.access.add_read("kv", pages_t * self.page_bytes
                                 + pages_d * self.draft_page_bytes)
            self.access.add_write("kv", rounds_used * (
                V * self.row_bytes + (k + 1) * self.draft_row_bytes))
            if self.kv_quantized and pages_t:
                self._c_dequant.inc(pages_t + pages_d)
            self._c_steps.inc(g)
            if req.timeline is not None and g:
                ts: List[float] = []
                for r in range(rounds_used):
                    ts.extend([t0 + (r + 1) * self.spec_round_time_s]
                              * int(m_r[r]))
                req.timeline.token_ts.extend(ts)
            self._ctx[i] = ctx + g
            t_end = t0 + rounds_used * self.spec_round_time_s
            # rollback by page truncation: both lanes drop every page past
            # the accepted context; freed pages rejoin the reservation
            ft, fd = self.ledger.truncate_rows(i, int(self._ctx[i]), t_end)
            nf = len(ft) + len(fd)
            if nf:
                keep = pages_for(int(self._ctx[i]), ps)
                self._table[i, keep:] = 0
                self._draft_table[i, keep:] = 0
                self._reserved[i] += nf
                self.stats.pages_freed += nf
                self.stats.rolled_back_pages += nf
                self._c_freed.inc(nf)
                self._c_rollback.inc(nf)
            if not still_active[i]:
                self._retire(i, req, done, t_end)
