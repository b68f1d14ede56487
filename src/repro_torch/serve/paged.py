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
`page_bytes` with int8's scales) and `collect_logits`. Not yet ported (the
batcher raises `NotImplementedError`): prefix caching, chunked prefill,
speculative decoding, priority preemption, telemetry and the energy meter.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.quant import kv_dtype_spec
from repro_torch.models.transformer import (init_paged_cache,
                                            write_prefill_to_pages)
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
    outstanding pages at all times and drains to zero."""

    def __init__(self, num_pages: int, page_bytes_: int):
        self.allocator = PageAllocator(num_pages)
        self.page_bytes = page_bytes_
        self.trace = OccupancyTrace("kv", (num_pages - 1) * page_bytes_)
        self.slot_pages: Dict[int, List[int]] = {}

    def admit(self, slot: int, n_pages: int, t: float) -> List[int]:
        if slot in self.slot_pages:
            raise ValueError(f"slot {slot} already admitted")
        pages = self.allocator.alloc(n_pages)
        self.slot_pages[slot] = list(pages)
        if n_pages:
            self.trace.event(t, n_pages * self.page_bytes, 0)
        return pages

    def grow(self, slot: int, total_pages: int, t: float) -> List[int]:
        have = self.slot_pages[slot]
        extra = total_pages - len(have)
        if extra <= 0:
            return []
        pages = self.allocator.alloc(extra)
        have.extend(pages)
        self.trace.event(t, extra * self.page_bytes, 0)
        return pages

    def retire(self, slot: int, t: float) -> int:
        pages = self.slot_pages.pop(slot)
        self.allocator.free(pages)
        if pages:
            self.trace.event(t, -len(pages) * self.page_bytes, 0)
        return len(pages)


@dataclass
class PagedStats(SchedulerStats):
    pages_allocated: int = 0
    pages_freed: int = 0
    peak_pages: int = 0
    chunks: int = 0


class PagedContinuousBatcher:
    """FIFO continuous batching over a paged KV cache.

    Admission pops the queue head when a slot is free and the pool can cover
    its worst-case pages (prompt + max_new_tokens), prefills the prompt once
    (batch=1) and scatters its KV rows into freshly allocated pages; older
    slots are never touched. Decode runs in chunks of `chunk_steps` device
    steps: the liveness mask, remaining budgets and EOS checks stay on the
    device, and the host syncs once per chunk to collect tokens, retire
    finished slots, free their pages and admit queued requests.

    `kv_dtype` selects the page storage (`kernels.quant.kv_dtype_spec`):
    the model dtype ("native"), another float dtype, fp8 E4M3 codes, or
    int8 with per-row scales, decoded through `paged_gqa_decode_quant`.
    With `collect_logits` every request also keeps the last-position logits
    of its prefill and of each decode step (`Request.logits`, float32).

    Emits the Stage-I artifact at page granularity: `occupancy_bundle()` is
    a `TraceBundle` whose "kv" trace steps in units of `page_bytes`, fed to
    `core.explorer.sweep` unchanged. Times on it are logical (`step_time_s`
    per decode step, `prefill_tok_s` per prefilled token), as in the
    reference, so the trace does not depend on the device's speed.
    """

    def __init__(self, model, params, *, num_slots: int = 4,
                 page_size: int = 16, num_pages: int = 64,
                 max_pages_per_slot: Optional[int] = None,
                 chunk_steps: int = 16, step_time_s: float = 1e-3,
                 prefill_tok_s: float = 5e-5, prefix_cache: bool = False,
                 collect_logits: bool = False, kv_dtype: str = "native",
                 prefill_chunk_tokens: Optional[int] = None,
                 speculate_k: Optional[int] = None):
        if speculate_k is not None and kv_dtype == "int8":
            raise NotImplementedError(
                "speculative verify scatters V rows per slot; the int8 "
                "page pool's per-row requantization under that scatter "
                "is not wired up (fp8/native pools are)")
        for name, value, plain in (
                ("prefix_cache", prefix_cache, False),
                ("prefill_chunk_tokens", prefill_chunk_tokens, None),
                ("speculate_k", speculate_k, None)):
            if value != plain:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet; the port serves "
                    "the plain path only")
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

        self.collect_logits = collect_logits
        kv_spec = kv_dtype_spec(kv_dtype, native=model.compute_dtype)
        self.kv_dtype = kv_spec.name
        self.page_bytes = page_bytes(self.cfg, page_size, kv_spec.itemsize,
                                     kv_spec.scale_bytes_per_row)
        self.row_bytes = self.page_bytes // page_size
        self.ledger = PagedKVLedger(num_pages, self.page_bytes)
        self.access = AccessStats()
        self.stats = PagedStats()

        self.queue = AdmissionQueue()
        self.slots: List[Optional[Request]] = [None] * num_slots
        self._reserved = [0] * num_slots        # worst-case pages not yet held
        self._ctx = np.zeros(num_slots, np.int64)
        self._next_tok = np.zeros(num_slots, np.int64)
        self._table = np.zeros((num_slots, self.max_pages_per_slot), np.int32)
        self._sim_t = 0.0
        self._cache = init_paged_cache(
            self.cfg, num_slots, num_pages, page_size,
            self.max_pages_per_slot, dtype=model.compute_dtype,
            device=self.device, kv_dtype=self.kv_dtype)

    # ------------------------------------------------------------ client API
    def submit(self, req: Request) -> None:
        if req.priority != 0:
            raise NotImplementedError("priority preemption is not ported "
                                      "yet; submit priority-0 requests")
        S = int(len(req.tokens))
        worst = self._worst_pages(S, req.max_new_tokens)
        if worst > self.max_pages_per_slot or worst > self.num_pages - 1:
            raise OutOfPages(
                f"request {req.rid} needs {worst} pages; slot tables hold "
                f"{self.max_pages_per_slot}, pool holds "
                f"{self.num_pages - 1}")
        req.submitted_wall_s = time.perf_counter()
        req.submitted_s = self._sim_t
        self.queue.push(req)

    def run(self, max_chunks: int = 10_000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_chunks):
            if not self.queue and all(s is None for s in self.slots):
                break
            self._admit(done)
            self._decode_chunk(done)
        return done

    def occupancy_bundle(self) -> TraceBundle:
        """Page-granular Stage-II view: feed to explorer.sweep() unchanged."""
        return TraceBundle(graph_name=f"{self.cfg.name}-paged-serve",
                           total_time=max(self._sim_t, self.step_time_s),
                           traces={"kv": self.ledger.trace},
                           access=self.access)

    # ------------------------------------------------------------- internals
    def _available_pages(self) -> int:
        return self.ledger.allocator.n_free - sum(self._reserved)

    def _worst_pages(self, S: int, max_new: int) -> int:
        return pages_for(S + max(max_new - 1, 0), self.page_size)

    def _retire(self, i: int, req: Request, done: List[Request],
                t: float) -> None:
        req.finished_wall_s = time.perf_counter()
        req.finished_s = t
        done.append(req)
        self.slots[i] = None
        n = self.ledger.retire(i, t)
        self.stats.pages_freed += n
        self.stats.retired_kv_bytes += n * self.page_bytes
        self.stats.finished += 1
        self._reserved[i] = 0
        self._ctx[i] = 0
        self._table[i, :] = 0

    def _admit(self, done: List[Request]) -> None:
        while self.queue:
            i = next((k for k, s in enumerate(self.slots) if s is None), None)
            if i is None:
                break
            req = self.queue.peek()
            prompt_len = int(len(req.tokens))
            worst = self._worst_pages(prompt_len, req.max_new_tokens)
            if worst > self._available_pages():
                break                      # wait for pages to free up
            self.queue.pop()
            npg = pages_for(prompt_len, self.page_size)
            t_pre = self._sim_t
            tokens = torch.as_tensor(np.asarray(req.tokens)[None, :],
                                     dtype=torch.long, device=self.device)
            logits, dense = self.model.prefill(self.params,
                                               {"tokens": tokens},
                                               npg * self.page_size)
            tok = int(torch.argmax(logits[0, -1]))
            self._sim_t += prompt_len * self.prefill_tok_s
            pages = self.ledger.admit(i, npg, self._sim_t)
            self._reserved[i] = worst - npg
            self.stats.pages_allocated += npg
            self.stats.peak_pages = max(self.stats.peak_pages,
                                        self.ledger.allocator.n_allocated)
            self.stats.admitted_kv_bytes += npg * self.page_bytes
            self.access.add_write("kv", prompt_len * self.row_bytes)
            write_prefill_to_pages(self.cfg, self._cache, dense, i,
                                   torch.as_tensor(pages, dtype=torch.int32))
            self._commit_admission(i, req, done, tok, logits, prompt_len,
                                   pages, t_pre)

    def _commit_admission(self, i: int, req: Request, done: List[Request],
                          tok: int, logits: torch.Tensor, ctx: int,
                          table_pages: List[int], t_pre: float) -> None:
        """Host mirrors, stats, the prefill-produced first token, and the
        immediate retire when that token already satisfies the request."""
        self.slots[i] = req
        self._ctx[i] = ctx
        self._next_tok[i] = tok
        self._table[i, :] = 0
        self._table[i, :len(table_pages)] = table_pages
        req.output.append(tok)
        if self.collect_logits:
            req.logits.append(logits[0, -1].float().cpu().numpy())
        self.stats.admitted += 1
        self.stats.prefills += 1
        self.stats.peak_active_slots = max(
            self.stats.peak_active_slots,
            sum(s is not None for s in self.slots))
        if (req.max_new_tokens <= 1
                or (req.eos_id is not None and tok == req.eos_id)):
            self._retire(i, req, done, self._sim_t)

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

    def _decode_chunk(self, done: List[Request]) -> None:
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if not live:
            return
        t0 = self._sim_t
        # grow page tables to cover this chunk's worst case (the reservation
        # made at admission guarantees these allocations succeed)
        remaining = np.zeros(self.num_slots, np.int64)
        for i in live:
            req = self.slots[i]
            remaining[i] = req.max_new_tokens - len(req.output)
            steps_i = min(self.chunk_steps, int(remaining[i]))
            new_pages = self.ledger.grow(
                i, pages_for(int(self._ctx[i]) + steps_i, self.page_size), t0)
            if new_pages:
                npg_have = len(self.ledger.slot_pages[i])
                self._table[i, npg_have - len(new_pages):npg_have] = new_pages
                self._reserved[i] -= len(new_pages)
                self.stats.pages_allocated += len(new_pages)
                self.stats.admitted_kv_bytes += len(new_pages) * self.page_bytes
        self.stats.peak_pages = max(self.stats.peak_pages,
                                    self.ledger.allocator.n_allocated)

        # the host is the source of truth between chunks: push the page-table
        # mirror and the liveness mask
        dev = self.device
        self._cache["page_table"] = torch.as_tensor(self._table, device=dev)
        self._cache["active"] = torch.as_tensor(
            [s is not None for s in self.slots], device=dev)
        eos = [self.slots[i].eos_id if self.slots[i] is not None
               and self.slots[i].eos_id is not None else -1
               for i in range(self.num_slots)]
        out, step_logits = self._decode_loop(
            torch.as_tensor(self._next_tok[:, None], device=dev),
            torch.as_tensor(eos, dtype=torch.long, device=dev),
            torch.as_tensor(remaining, device=dev))
        out = out.cpu().numpy()
        if step_logits is not None:
            step_logits = step_logits.cpu().numpy()
        emitted = out[:self.chunk_steps]
        self._next_tok = out[self.chunk_steps].copy()
        still_active = out[self.chunk_steps + 1].astype(bool)
        self.stats.chunks += 1
        self._sim_t = t0 + self.chunk_steps * self.step_time_s

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
            self._ctx[i] += g
            if not still_active[i]:
                self._retire(i, req, done, t0 + g * self.step_time_s)
