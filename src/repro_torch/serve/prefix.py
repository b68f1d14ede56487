"""Prefix-sharing KV reuse: radix prefix index + refcounted COW page sharing
(port of the reference package's `repro/serve/prefix.py`; host code, copied
line for line, the energy-meter mirror and the telemetry counters
included).

At serving scale the dominant KV-occupancy lever beyond GQA is cross-request
reuse: real traffic (chat system prompts, few-shot templates, agentic
fan-out) repeats long prompt prefixes across concurrent slots. Because the
paged cache already reaches KV rows *through a page table*, sharing needs no
kernel change — two slots whose tables point at the same page read the same
rows. Three host-side pieces make that safe and time-resolved:

  * :class:`SharedPageAllocator` — refcount facade over the free-list
    allocator: a page is freed only when its last reference (slot table
    entries + the prefix index) drops;
  * :class:`RadixPrefixIndex` — radix tree over token sequences at page
    granularity. Interior nodes are full pages shared read-only; a run's
    last, partially-filled page is a leaf that is **copy-on-write split**
    on the first divergent write (a new request extending it, or the
    owning slot's own decode append). Unreferenced leaves are LRU-evicted
    under page pressure — eviction only ever frees index-only pages, never
    one a live slot references;
  * :class:`SharedKVLedger` — drop-in for `PagedKVLedger` that emits **dual
    occupancy traces**: *logical* (sum of per-slot page demand — what a
    no-sharing allocator would pin) and *physical* (unique slot-referenced
    pages as `needed`, cached-but-unreferenced pages as `obsolete`). The
    physical trace is a plain Stage-I `OccupancyTrace`, so Stage II sweeps
    banking/gating configs against true residency unchanged, and the
    logical-minus-physical gap is exactly the gating headroom sharing
    unlocks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.paged import PageAllocator, pages_for
from repro_torch.sim.trace import OccupancyTrace


# ---------------------------------------------------------------------------
# Refcounted allocator
# ---------------------------------------------------------------------------

class SharedPageAllocator:
    """Refcount layer over :class:`PageAllocator`.

    Every live reference — one per slot page-table entry, one for the prefix
    index's cache entry — holds the page. `alloc` hands out pages at
    refcount 1; `retain`/`release` move the count; the base free list gets
    the page back only at zero. Conservation (`n_free + n_allocated ==
    num_pages - 1`, page 0 reserved) holds at every step."""

    def __init__(self, num_pages: int):
        self._base = PageAllocator(num_pages)
        self.num_pages = num_pages
        self._refs: Dict[int, int] = {}

    @property
    def n_free(self) -> int:
        return self._base.n_free

    @property
    def n_allocated(self) -> int:
        return self._base.n_allocated

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self, n: int) -> List[int]:
        pages = self._base.alloc(n)
        for p in pages:
            self._refs[p] = 1
        return pages

    def retain(self, pages: Sequence[int]) -> None:
        for p in pages:
            if self._refs.get(p, 0) < 1:
                raise ValueError(f"retain of unallocated page {p}")
            self._refs[p] += 1

    def release(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; returns the pages actually freed."""
        freed = []
        for p in pages:
            c = self._refs.get(p, 0)
            if c < 1:
                raise ValueError(f"release of unallocated page {p}")
            if c == 1:
                del self._refs[p]
                self._base.free([p])
                freed.append(p)
            else:
                self._refs[p] = c - 1
        return freed


# ---------------------------------------------------------------------------
# Radix prefix index
# ---------------------------------------------------------------------------

@dataclass
class PrefixMatch:
    """Longest cached prefix of a probed prompt, page-granular.

    `pages` are fully-matched pages (`page_size` tokens each, safe to map
    read-only); `tail_page`/`tail_tokens` describe a partially-matched
    cached page whose first `tail_tokens` rows are valid for this prompt —
    usable only through a copy (COW at admission)."""
    pages: List[int] = field(default_factory=list)
    tail_page: Optional[int] = None
    tail_tokens: int = 0

    def tokens(self, page_size: int) -> int:
        return len(self.pages) * page_size + self.tail_tokens


class _Node:
    __slots__ = ("tokens", "page", "children", "parent", "stamp")

    def __init__(self, tokens: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.tokens = tokens
        self.page = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.stamp = 0

    def key(self) -> Tuple[int, ...]:
        return self.tokens


class RadixPrefixIndex:
    """Radix tree over token sequences, one page per node.

    A node's key is the exact token tuple its page holds (`page_size`
    tokens for interior/full nodes, fewer for partial leaves). The index
    owns one allocator reference per cached node, taken at `insert` and
    dropped at eviction; probing touches the matched path so eviction is
    leaf-LRU."""

    def __init__(self, page_size: int, allocator: SharedPageAllocator,
                 telemetry=None):
        from repro_torch.obs.telemetry import noop_registry
        tel = telemetry if telemetry is not None else noop_registry()
        self._c_probe_hits = tel.counter("serve.prefix.probe_hits")
        self._c_probe_miss = tel.counter("serve.prefix.probe_misses")
        self._c_matched = tel.counter("serve.prefix.tokens_matched")
        self._c_inserted = tel.counter("serve.prefix.pages_inserted")
        self.page_size = page_size
        self.allocator = allocator
        self._root = _Node((), -1, None)
        self._clock = 0
        self.n_nodes = 0

    # ----------------------------------------------------------------- probe
    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.stamp = self._clock

    def probe(self, tokens: np.ndarray, limit: Optional[int] = None
              ) -> PrefixMatch:
        """Longest cached prefix of `tokens[:limit]`.

        Full pages match by exact key lookup; at the frontier the child
        with the longest common token prefix (if any) becomes the partial
        tail. Matched nodes are LRU-touched."""
        ps = self.page_size
        toks = [int(t) for t in tokens]
        if limit is not None:
            toks = toks[:limit]
        m = PrefixMatch()
        node = self._root
        pos = 0
        while True:
            rem = toks[pos:]
            nxt = None
            if len(rem) >= ps:
                nxt = node.children.get(tuple(rem[:ps]))
            if nxt is not None:
                m.pages.append(nxt.page)
                self._touch(nxt)
                node = nxt
                pos += ps
                continue
            # frontier: best partial match among children
            best, best_j = None, 0
            for child in node.children.values():
                j = 0
                for a, b in zip(child.tokens, rem):
                    if a != b:
                        break
                    j += 1
                if j > best_j:
                    best, best_j = child, j
            if best is not None:
                m.tail_page = best.page
                m.tail_tokens = best_j
                self._touch(best)
            matched = m.tokens(ps)
            if matched:
                self._c_probe_hits.inc()
                self._c_matched.inc(matched)
            else:
                self._c_probe_miss.inc()
            return m

    # ---------------------------------------------------------------- insert
    def insert(self, tokens: np.ndarray, pages: Sequence[int]) -> int:
        """Cache a run: `pages` hold the KV of `tokens`, page-aligned
        (`len(pages) == pages_for(len(tokens), page_size)`; the last page
        may be partial). For every *newly created* node the index retains
        its page. Existing nodes with identical keys are kept (the caller's
        duplicate page simply stays private). Returns #pages newly cached."""
        ps = self.page_size
        toks = [int(t) for t in tokens]
        assert len(pages) == pages_for(len(toks), ps), \
            (len(pages), len(toks), ps)
        node = self._root
        new = 0
        for i, page in enumerate(pages):
            chunk = tuple(toks[i * ps:(i + 1) * ps])
            existing = node.children.get(chunk)
            if existing is not None:
                self._touch(existing)
                node = existing
                continue
            child = _Node(chunk, int(page), node)
            self.allocator.retain([page])
            node.children[chunk] = child
            self._touch(child)
            self.n_nodes += 1
            new += 1
            if len(chunk) < ps:
                break            # partial pages are leaves (never descended)
            node = child
        self._c_inserted.inc(new)
        return new

    # --------------------------------------------------------------- queries
    def pages(self) -> List[int]:
        out = []
        stack = [self._root]
        while stack:
            n = stack.pop()
            if n is not self._root:
                out.append(n.page)
            stack.extend(n.children.values())
        return out

    @property
    def n_cached_pages(self) -> int:
        return self.n_nodes

    def runs(self) -> List[List[int]]:
        """Token sequences of every root-to-leaf path (invariant checks)."""
        out = []

        def walk(node, acc):
            if node is not self._root:
                acc = acc + list(node.tokens)
            if not node.children:
                if node is not self._root:
                    out.append(acc)
                return
            for c in node.children.values():
                walk(c, acc)
        walk(self._root, [])
        return out

    # -------------------------------------------------------------- eviction
    def evict(self, n_pages: int) -> List[int]:
        """Free >= `n_pages` pages by dropping LRU leaves whose page has no
        reference beyond the index itself. Dropping a leaf may expose its
        parent (pushed as a new candidate); the cascade continues until
        enough pages are freed or no evictable leaf remains. Never frees a
        slot-referenced page. One tree traversal + a heap: O((k+n) log n)
        for k evictions over n cached nodes."""
        import heapq
        freed: List[int] = []
        heap = [(n.stamp, id(n), n) for n in self._iter_nodes()
                if not n.children]
        heapq.heapify(heap)
        while heap and len(freed) < n_pages:
            _, _, victim = heapq.heappop(heap)
            if self.allocator.refcount(victim.page) != 1:
                continue     # slot-shared: not evictable (and stays a leaf)
            freed.extend(self.allocator.release([victim.page]))
            parent = victim.parent
            del parent.children[victim.key()]
            self.n_nodes -= 1
            if parent is not self._root and not parent.children:
                heapq.heappush(heap, (parent.stamp, id(parent), parent))
        return freed

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())


# ---------------------------------------------------------------------------
# Dual-trace ledger
# ---------------------------------------------------------------------------

class SharedKVLedger:
    """Page ledger with prefix sharing and dual occupancy traces.

    Drop-in for `PagedKVLedger` where it matters to the batcher (`admit` /
    `grow` / `retire` / `occupancy_bytes`), plus sharing verbs (`map_shared`
    via `admit`, `cow`, `evict_for`) and an owned :class:`RadixPrefixIndex`.

    Trace semantics (synced after every mutation):
      * `trace`   ("kv", physical): needed = unique pages referenced by at
        least one slot; obsolete = allocated pages held only by the index
        (the reuse cache — resident, retained, but gateable against demand);
      * `logical` ("kv_logical"): sum over slots of their page counts — the
        occupancy a non-sharing allocator would report. physical needed <=
        logical always; the gap is the sharing win."""

    def __init__(self, num_pages: int, page_bytes_: int, page_size: int,
                 num_slots: int = 0, max_pages_per_slot: int = 0,
                 telemetry=None):
        from repro_torch.obs.telemetry import noop_registry
        tel = telemetry if telemetry is not None else noop_registry()
        self.tel = tel
        self._c_evicted = tel.counter("serve.prefix.evicted_pages")
        self._c_cow = tel.counter("serve.prefix.cow_splits")
        self._g_physical = tel.gauge("serve.prefix.pages_physical")
        self._g_cached = tel.gauge("serve.prefix.pages_cached")
        self._g_logical = tel.gauge("serve.prefix.pages_logical")
        self.allocator = SharedPageAllocator(num_pages)
        self.index = RadixPrefixIndex(page_size, self.allocator,
                                      telemetry=telemetry)
        self.page_bytes = page_bytes_
        self.page_size = page_size
        cap = (num_pages - 1) * page_bytes_
        logical_cap = (num_slots * max_pages_per_slot * page_bytes_
                       if num_slots and max_pages_per_slot else cap)
        self.trace = OccupancyTrace("kv", cap)
        self.logical = OccupancyTrace("kv_logical", logical_cap)
        self.slot_pages: Dict[int, List[int]] = {}
        self._last = (0, 0, 0)      # (needed, obsolete, logical) in pages
        # Speculative-decoding draft lane: per-slot private pages drawn from
        # the SAME allocator/page-id space but never shared, never indexed.
        self.draft_pages: Dict[int, List[int]] = {}
        self.draft_page_bytes: Optional[int] = None
        self._last_draft = 0
        # optional streaming energy meter (obs.energy.BankEnergyMeter):
        # sync() mirrors every physical delta to it, tagged with the
        # mutating slot's request/tenant; the attribution weight is the
        # slot's *logical* holdings change (shared pages sustain banks for
        # every referencing request, so each holds its full logical share)
        self.meter = None
        self.slot_meta: Dict[int, tuple] = {}
        self._meter_w: Dict[int, int] = {}

    def set_slot_meta(self, slot: int, rid, tenant=None) -> None:
        """Tag a slot so mirrored meter events attribute to its request."""
        self.slot_meta[slot] = (rid, tenant)

    # ------------------------------------------------------------ accounting
    def occupancy_bytes(self) -> int:
        nd = sum(len(p) for p in self.draft_pages.values())
        db = (self.draft_page_bytes if self.draft_page_bytes is not None
              else self.page_bytes)
        return (self.allocator.n_allocated - nd) * self.page_bytes + nd * db

    def logical_bytes(self) -> int:
        """Sum over slots of their page footprint — what a non-sharing
        allocator would hold. `occupancy_bytes` <= this; gap = sharing win."""
        return sum(len(p) for p in self.slot_pages.values()) * self.page_bytes

    def _counts(self) -> Tuple[int, int, int]:
        sref = set()
        logical = 0
        for pages in self.slot_pages.values():
            sref.update(pages)
            logical += len(pages)
        needed = len(sref)
        ndraft = sum(len(p) for p in self.draft_pages.values())
        obsolete = self.allocator.n_allocated - needed - ndraft
        return needed, obsolete, logical

    def sync(self, t: float, slot: Optional[int] = None,
             cause: Optional[str] = None) -> None:
        """Emit the delta between the live page counts and the last synced
        state on both traces. Call after any out-of-band index mutation.
        Draft-lane pages count as `needed` (they back live slots) at the
        draft lane's own page bytes; with the lane unused the accounting is
        bit-identical to the pre-speculation ledger. `slot`/`cause` tag the
        mutation for the (optional) energy meter mirror."""
        needed, obsolete, logical = self._counts()
        ndraft = sum(len(p) for p in self.draft_pages.values())
        pn, po, pl = self._last
        pd = self._last_draft
        pb = self.page_bytes
        db = (self.draft_page_bytes if self.draft_page_bytes is not None
              else pb)
        dn = (needed - pn) * pb + (ndraft - pd) * db
        do = (obsolete - po) * pb
        self.trace.event(t, dn, do)
        self.logical.event(t, (logical - pl) * pb + (ndraft - pd) * db, 0)
        self._last = (needed, obsolete, logical)
        self._last_draft = ndraft
        self._g_physical.set(needed)
        self._g_cached.set(obsolete)
        self._g_logical.set(logical)
        if self.meter is not None:
            wd = 0
            if slot is not None:
                w = (len(self.slot_pages.get(slot, ())) * pb
                     + len(self.draft_pages.get(slot, ())) * db)
                wd = w - self._meter_w.pop(slot, 0)
                if w:
                    self._meter_w[slot] = w
            if dn or do or wd:
                rid, tenant = ((None, None) if slot is None
                               else self.slot_meta.get(slot, (None, None)))
                self.meter.record(t, dn, do, rid=rid, tenant=tenant,
                                  cause=cause, weight_delta=wd)

    # ------------------------------------------------------------------ verbs
    def admit(self, slot: int, n_pages: int, t: float,
              shared: Sequence[int] = ()) -> List[int]:
        """Create the slot: map `shared` pages (refcount++) and allocate
        `n_pages` fresh private pages after them. Returns the fresh pages."""
        assert slot not in self.slot_pages, f"slot {slot} already admitted"
        shared = list(shared)
        self.allocator.retain(shared)
        try:
            fresh = self.allocator.alloc(n_pages)
        except Exception:
            self.allocator.release(shared)
            raise
        self.slot_pages[slot] = shared + fresh
        self.sync(t, slot, "admission")
        return fresh

    def grow(self, slot: int, total_pages: int, t: float,
             cause: str = "decode_growth") -> List[int]:
        have = self.slot_pages[slot]
        extra = total_pages - len(have)
        if extra <= 0:
            return []
        fresh = self.allocator.alloc(extra)
        have.extend(fresh)
        self.sync(t, slot, cause)
        return fresh

    def cow(self, slot: int, table_idx: int, t: float) -> int:
        """Copy-on-write split of the slot's `table_idx`-th page: allocate a
        private page, swap it into the slot's list, drop the slot's
        reference on the shared original (which survives wherever else it
        is referenced — index or other slots). Returns the new page id; the
        caller copies the device contents."""
        old = self.slot_pages[slot][table_idx]
        if self.allocator.refcount(old) <= 1:
            raise ValueError(f"page {old} is private; COW is for shared pages")
        new = self.allocator.alloc(1)[0]
        self.slot_pages[slot][table_idx] = new
        self.allocator.release([old])
        self._c_cow.inc()
        self.sync(t, slot, "cow")
        return new

    def retire(self, slot: int, t: float) -> int:
        """Release every page the slot references — target lane and (if
        present) draft lane. Pages the index still caches become `obsolete`
        occupancy (the reuse cache); the rest return to the free list.
        Returns the pages *actually freed*."""
        pages = self.slot_pages.pop(slot)
        pages = list(pages) + self.draft_pages.pop(slot, [])
        freed = self.allocator.release(pages)
        self.sync(t, slot)
        self.slot_meta.pop(slot, None)
        return len(freed)

    # ------------------------------------------------- speculative draft lane
    def enable_draft_lane(self, draft_page_bytes: int) -> None:
        """Declare the byte width of draft-lane pages (the draft model's
        per-page KV footprint). Draft pages come out of the same allocator
        and page-id space as target pages but are strictly private: never
        radix-indexed, never shared, never COW'd."""
        self.draft_page_bytes = int(draft_page_bytes)

    def admit_draft(self, slot: int, n_pages: int, t: float) -> List[int]:
        assert slot not in self.draft_pages, \
            f"slot {slot} already has a draft lane"
        fresh = self.allocator.alloc(n_pages)
        self.draft_pages[slot] = fresh
        self.sync(t, slot, "admission")
        return fresh

    def grow_draft(self, slot: int, total_pages: int, t: float) -> List[int]:
        have = self.draft_pages[slot]
        extra = total_pages - len(have)
        if extra <= 0:
            return []
        fresh = self.allocator.alloc(extra)
        have.extend(fresh)
        self.sync(t, slot, "decode_growth")
        return fresh

    def truncate_rows(self, slot: int, n_rows: int, t: float
                      ) -> Tuple[List[int], List[int]]:
        """Rollback-by-page-truncation: drop the slot's references to every
        page past `pages_for(n_rows)`, in both lanes. Shared prefix pages
        merely lose one reference (the refcount layer guarantees they are
        never mutated or reclaimed while the index or another slot holds
        them); private tail pages return to the free list. Returns the
        (target, draft) pages actually freed."""
        keep = pages_for(n_rows, self.page_size)
        have = self.slot_pages[slot]
        freed_t: List[int] = []
        dirty = False
        if keep < len(have):
            tail = have[keep:]
            del have[keep:]
            freed_t = self.allocator.release(tail)
            dirty = True
        freed_d: List[int] = []
        dhave = self.draft_pages.get(slot)
        if dhave is not None and keep < len(dhave):
            dtail = dhave[keep:]
            del dhave[keep:]
            freed_d = self.allocator.release(dtail)
            dirty = True
        if dirty:
            self.sync(t, slot, "spec_rollback")
        return freed_t, freed_d

    def evict_for(self, n_pages: int, t: float) -> int:
        """LRU-evict cached prefixes until `n_pages` are freed (or nothing
        evictable remains). Returns pages actually freed."""
        freed = self.index.evict(n_pages)
        if freed:
            self._c_evicted.inc(len(freed))
            self.sync(t)
        return len(freed)

    def insert_run(self, tokens: np.ndarray, pages: Sequence[int],
                   t: float) -> int:
        new = self.index.insert(tokens, pages)
        if new:
            self.sync(t)
        return new
