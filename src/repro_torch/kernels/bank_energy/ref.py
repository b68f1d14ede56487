"""Plain PyTorch versions of the Stage-II bank-energy kernels.

Same contracts as the reference package's `exact_bank_stats_np` and
`bank_energy_np` (`repro/kernels/bank_energy/ref.py`), in float64 on any
device: the CPU path of `ops.py`, and what the CUDA kernels are held against
on the card.

  * `bank_energy_ref`      — (C, 2): [active bank-seconds, activity toggles].
  * `exact_bank_stats_ref` — (C, 5): [active bank-seconds, idle runs >=
    threshold, their seconds, idle runs < threshold, their seconds].

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
