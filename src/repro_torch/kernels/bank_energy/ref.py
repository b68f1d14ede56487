"""Plain PyTorch versions of the Stage-II bank-energy kernels.

Same contracts as the reference package's `exact_bank_stats_np` and
`bank_energy_np` (`repro/kernels/bank_energy/ref.py`), in float64 on any
device: the CPU path of `ops.py`, and what the CUDA kernels are held against
on the card.

  * `bank_energy_ref`      — (C, 2): [active bank-seconds, activity toggles].
  * `exact_bank_stats_ref` — (C, 5): [active bank-seconds, idle runs >=
    threshold, their seconds, idle runs < threshold, their seconds].

Two mirrors of how the CUDA kernels cut the work, for the tests (nothing on
the card's path calls them): `exact_bank_stats_chunked_ref` (chunk
summaries, a prefix max over chunks as carry, runs classified per chunk)
and `bank_energy_tiled_ref` (per-tile partials reduced in tile order).

The exact statistics are dense and segment-parallel over (candidate, bank,
segment): a bank's idle run ends at each rise of its "required" series, and
it started at the running maximum of the end times of the required segments
before it. Run durations are differences of one running-time array, the
sequential f64 cumulative sum that `np.cumsum` computes, so counts and
run-second sums match the numpy reference to its rounding. That sum is
taken on the CPU (PyTorch's CPU cumsum adds in order; a device scan would
round differently).
"""
from __future__ import annotations

import torch

STAT_COLS = 5      # [act_seconds, n_long, long_seconds, n_short, short_seconds]
MAX_ELEMS = 1 << 25   # elements of one chunk's temporaries


def _activity(occupancy: torch.Tensor, usable: torch.Tensor,
              nbanks: torch.Tensor) -> torch.Tensor:
    """(C, S) banks required per segment: min(ceil(occ / usable), nbanks)."""
    return torch.minimum(torch.ceil(occupancy[None, :] / usable[:, None]),
                         nbanks[:, None])


def running_time(durations: torch.Tensor) -> torch.Tensor:
    """(S + 1,) f64 [0, d0, d0 + d1, ...] summed in order, on `durations`'s
    device."""
    cum = torch.cumsum(durations.detach().to("cpu", torch.float64), 0)
    return torch.cat([cum.new_zeros(1), cum]).to(durations.device)


def bank_energy_ref(durations: torch.Tensor, occupancy: torch.Tensor,
                    usable: torch.Tensor,
                    nbanks: torch.Tensor) -> torch.Tensor:
    """(C, 2) f64: [sum_k act_k * dur_k, sum_k |act_k - act_{k-1}|]."""
    d = durations.to(torch.float64)
    o = occupancy.to(torch.float64)
    u = usable.to(torch.float64)
    nb = nbanks.to(torch.float64)
    out = torch.zeros((len(u), 2), dtype=torch.float64, device=d.device)
    if len(d) == 0:
        return out
    step = max(1, MAX_ELEMS // len(d))
    for c0 in range(0, len(u), step):
        act = _activity(o, u[c0:c0 + step], nb[c0:c0 + step])
        out[c0:c0 + step, 0] = act @ d
        out[c0:c0 + step, 1] = (act[:, 1:] - act[:, :-1]).abs().sum(1)
    return out


def exact_bank_stats_ref(durations: torch.Tensor, occupancy: torch.Tensor,
                         usable: torch.Tensor, nbanks: torch.Tensor,
                         threshold: torch.Tensor) -> torch.Tensor:
    """(C, 5) f64 exact idle-run statistics per candidate.

    A bank is ON before the trace starts (segment 0 never closes a run), and
    the run still open at trace end is flushed with duration
    `total - last required end`. Candidates are processed in chunks so each
    chunk's (C_chunk, B, S) temporaries stay under `MAX_ELEMS` elements."""
    d = durations.to(torch.float64)
    o = occupancy.to(torch.float64)
    u = usable.to(torch.float64)
    nb = nbanks.to(torch.float64)
    th = threshold.to(torch.float64)
    n_cand, n_seg = len(u), len(d)
    out = torch.zeros((n_cand, STAT_COLS), dtype=torch.float64,
                      device=d.device)
    if n_cand == 0 or n_seg == 0:
        return out
    cum = running_time(d)
    start, end, total = cum[:-1], cum[1:], cum[-1]
    bmax = int(nb.max().item())
    bank = torch.arange(bmax, dtype=torch.float64, device=d.device)
    step = max(1, MAX_ELEMS // (bmax * n_seg))
    for c0 in range(0, n_cand, step):
        sl = slice(c0, c0 + step)
        act = _activity(o, u[sl], nb[sl])                      # (c, S)
        out[sl, 0] = act @ d
        exceed = act[:, None, :] > bank[None, :, None]         # (c, B, S)
        in_range = (bank[None, :] < nb[sl, None])              # (c, B)
        last = torch.where(exceed, end, torch.zeros_like(end)).cummax(
            dim=2).values
        run_start = torch.cat([torch.zeros_like(last[..., :1]),
                               last[..., :-1]], dim=2)
        prev = torch.cat([torch.ones_like(exceed[..., :1]),
                          exceed[..., :-1]], dim=2)
        rise = exceed & ~prev & in_range[..., None]
        run = start - run_start                                # (c, B, S)
        tail_run = total - last[..., -1]                       # (c, B)
        tail = ~exceed[..., -1] & in_range
        th_c = th[sl]
        long_rise = rise & (run >= th_c[:, None, None])
        short_rise = rise & ~long_rise
        long_tail = tail & (tail_run >= th_c[:, None])
        short_tail = tail & ~long_tail
        zero = torch.zeros((), dtype=torch.float64, device=d.device)
        out[sl, 1] = long_rise.sum((1, 2)) + long_tail.sum(1)
        out[sl, 2] = (torch.where(long_rise, run, zero).sum((1, 2))
                      + torch.where(long_tail, tail_run, zero).sum(1))
        out[sl, 3] = short_rise.sum((1, 2)) + short_tail.sum(1)
        out[sl, 4] = (torch.where(short_rise, run, zero).sum((1, 2))
                      + torch.where(short_tail, tail_run, zero).sum(1))
    return out


def exact_bank_stats_chunked_ref(durations: torch.Tensor,
                                 occupancy: torch.Tensor,
                                 usable: torch.Tensor, nbanks: torch.Tensor,
                                 threshold: torch.Tensor,
                                 chunk: int) -> torch.Tensor:
    """(C, 5) f64, `exact_bank_stats_ref`'s statistics computed the way the
    `exact_bank_stats` kernel decomposes them, chunks of `chunk` segments
    at a time.

    With a virtual activity nb before the trace (all banks ON) and after it
    (the flush), bank b falls at position k when a_{k-1} > b >= a_k and
    rises when a_{k-1} <= b < a_k, k in [0, S]; each rise ends an idle run
    that began at the bank's last fall, run = cum[rise] - cum[fall]. A
    chunk sees the rises of its own positions (position S belongs to the
    last chunk). A rise whose bank fell inside the chunk is a run of the
    chunk; the first rise of a bank idle since before the chunk is its open
    rise. The chunk's summary per bank is its last fall (-1 if none); the
    exclusive prefix max of those over the chunks is each chunk's carry-in,
    which closes its open rises. Counts are integers; seconds are summed
    per chunk, then over chunks in order, then over the open rises."""
    d = durations.to(torch.float64)
    o = occupancy.to(torch.float64)
    u = usable.to(torch.float64)
    nb = nbanks.to(torch.float64)
    th = threshold.to(torch.float64)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    n_cand, n_seg = len(u), len(d)
    dev = d.device
    out = torch.zeros((n_cand, STAT_COLS), dtype=torch.float64, device=dev)
    if n_cand == 0 or n_seg == 0:
        return out
    cum = running_time(d)
    n_chunks = -(-n_seg // chunk)
    pos = torch.arange(n_seg + 1, device=dev)
    chunk_of = (pos // chunk).clamp(max=n_chunks - 1)
    entry = chunk_of * chunk                 # first position of k's chunk
    for c in range(n_cand):
        act = _activity(o, u[c:c + 1], nb[c:c + 1])[0]
        out[c, 0] = torch.zeros(n_chunks, dtype=torch.float64,
                                device=dev).index_add_(
            0, chunk_of[:-1], act * d).sum()
        n = int(nb[c].item())
        a = act.clamp(min=0).long()
        virt = a.new_full((1,), n)
        prev = torch.cat([virt, a])          # activity before position k
        cur = torch.cat([a, virt])           # activity at position k
        bank = torch.arange(n, device=dev)[:, None]
        fall = (prev > bank) & (cur <= bank)                   # (n, S + 1)
        rise = (prev <= bank) & (cur > bank)
        fall_pos = torch.where(fall, pos, torch.full_like(pos, -1))
        # the bank's last fall strictly before k (k is not both)
        before = torch.cat([fall_pos.new_full((n, 1), -1),
                            fall_pos.cummax(1).values[:, :-1]], 1)
        local = rise & (before >= entry)
        opened = rise & ~local
        last_fall = fall_pos.new_full((n, n_chunks), -1).scatter_reduce_(
            1, chunk_of.expand(n, -1), fall_pos, "amax")
        carry = torch.cat([last_fall.new_full((n, 1), -1),
                           last_fall.cummax(1).values[:, :-1]], 1)
        start = torch.where(local, before, carry[:, chunk_of])
        if bool((start[opened] < 0).any()):
            raise AssertionError("an open rise without a fall before it")
        run = cum[pos] - cum[start.clamp(min=0)]               # (n, S + 1)
        is_long = run >= th[c]
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        for col, sel in ((1, is_long), (3, ~is_long)):
            loc, opn = local & sel, opened & sel
            out[c, col] = float(loc.sum() + opn.sum())
            per_chunk = torch.zeros(n_chunks, dtype=torch.float64,
                                    device=dev).index_add_(
                0, chunk_of, torch.where(loc, run, zero).sum(0))
            out[c, col + 1] = (per_chunk.sum()
                               + torch.where(opn, run, zero).sum())
    return out


def bank_energy_tiled_ref(durations: torch.Tensor, occupancy: torch.Tensor,
                          usable: torch.Tensor, nbanks: torch.Tensor,
                          tile: int) -> torch.Tensor:
    """(C, 2) f64, `bank_energy_ref`'s statistics computed the way the
    `bank_energy` kernel decomposes them: per tile of `tile` segments the
    bank-seconds of its segments and the toggles into them (the toggle from
    the tile's previous segment into its first included), then the tiles'
    partials summed in tile order."""
    d = durations.to(torch.float64)
    o = occupancy.to(torch.float64)
    u = usable.to(torch.float64)
    nb = nbanks.to(torch.float64)
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    out = torch.zeros((len(u), 2), dtype=torch.float64, device=d.device)
    if len(d) == 0:
        return out
    n_tiles = -(-len(d) // tile)
    tile_of = torch.arange(len(d), device=d.device) // tile
    step = max(1, MAX_ELEMS // len(d))
    for c0 in range(0, len(u), step):
        act = _activity(o, u[c0:c0 + step], nb[c0:c0 + step])   # (c, S)
        part = act.new_zeros((len(act), n_tiles, 2))
        part[:, :, 0].index_add_(1, tile_of, act * d)
        part[:, :, 1].index_add_(1, tile_of[1:],
                                 (act[:, 1:] - act[:, :-1]).abs())
        out[c0:c0 + step] = part.sum(1)
    return out
