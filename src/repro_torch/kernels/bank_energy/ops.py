"""Stage-II trace analytics: dispatch between the CUDA kernels and their
plain versions.

Ports `repro/kernels/bank_energy/ops.py`. Entry points, each evaluating a
whole (C, B, alpha) candidate grid in one call:

  * `bank_activity_stats` — lower-bound stats (bank-seconds, toggles), the
    kernel `bank_energy` (replaces the TPU `bank_energy_kernel`);
  * `exact_bank_stats`    — exact idle-run stats, the kernel
    `exact_bank_stats` (replaces the TPU `exact_bank_stats_kernel`) after
    the running time;
  * `running_time`        — the trace's running time, the sequential f64
    scan `running_time` (the first half of the TPU `exact_bank_stats_kernel`,
    which carried it across tiles). A caller that evaluates one trace twice
    computes it once and passes it to `exact_bank_stats` as `cum`.

All take float64 inputs and accumulate in float64: occupancy is byte-valued
and passes 2^24 for the paper's 128 MiB arrays, and the reference's float32
path drifts on traces of microsecond segments. On a CUDA tensor a wrapper
launches its kernel (`csrc/bank_energy.cu`) or raises; on a CPU tensor it
runs the plain version in `ref.py`. `walk_plan` and `energy_plan` are the
host arithmetic that cuts a call into blocks.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.bank_energy import ref
from repro_torch.kernels.bank_energy.ref import (bank_energy_ref,
                                                 exact_bank_stats_ref)

MAX_BANKS = 256     # banks of one candidate
# csrc/bank_energy.cu's kWarps and kStage: warps of a block in every bank
# kernel, segments a walk block stages per step
WARPS = 8
WALK_STAGE = 512
WALK_CHUNK_MIN = 512
# walk blocks per SM to aim for: many short blocks even out the uneven
# event counts of the chunks
WALK_BLOCKS_PER_SM = 32
# entries (candidate x bank x chunk) of each of the walk's two int32
# summaries: 32 MiB each
WALK_SUMMARY_MAX = 1 << 23
ENERGY_GROUP_MAX = 128   # candidates of one lower-bound block
ENERGY_TILE_MIN, ENERGY_TILE_MAX = 256, 2048

_P = ctypes.c_void_p
SCAN = build.register(build.CudaKernel(
    "running_time", "bank_energy", "running_time_f64",
    [_P, _P, ctypes.c_longlong, _P]))
EXACT = build.register(build.CudaKernel(
    "exact_bank_stats", "bank_energy", "exact_bank_stats_f64",
    [_P] * 10 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P]))
BOUND = build.register(build.CudaKernel(
    "bank_energy", "bank_energy", "bank_energy_f64",
    [_P] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _P]))


def walk_plan(S: int, C: int, bmax: int, sms: int) -> Tuple[int, int, int,
                                                             int]:
    """(G, W, chunk, Q) of an exact-stats call on a card of `sms` SMs: a
    block's 8 warps walk G candidates x W consecutive chunks (G a power of
    two, 8 once C >= 8), each warp one chunk of `chunk` segments for one
    candidate; Q chunks cover the trace. Chunks are as short as gives about
    WALK_BLOCKS_PER_SM blocks per SM, but at least WALK_CHUNK_MIN segments,
    a whole number of staged pieces (WALK_STAGE / W), and few enough that
    the summaries stay under WALK_SUMMARY_MAX entries. Counts do not depend
    on the plan; the order of the f64 sums does, so a plan is a function of
    the shapes and the card alone."""
    G = 8 if C >= 8 else 1 << (C.bit_length() - 1)
    W = WARPS // G
    piece = WALK_STAGE // W
    groups = -(-C // G)
    q = -(-WALK_BLOCKS_PER_SM * sms // groups) * W
    q = max(1, min(q, WALK_SUMMARY_MAX // (C * bmax),
                   -(-S // WALK_CHUNK_MIN)))
    chunk = -(-(-(-S // q)) // piece) * piece
    return G, W, chunk, -(-S // chunk)


def energy_plan(S: int, C: int, sms: int) -> Tuple[int, int]:
    """(tile, group) of a lower-bound call: blocks of `group` candidates x
    `tile` segments (group <= ENERGY_GROUP_MAX, the candidates split
    evenly), tiles doubled from ENERGY_TILE_MIN while that still leaves at
    least 4 blocks per SM."""
    groups = -(-C // ENERGY_GROUP_MAX)
    tile = ENERGY_TILE_MIN
    while (tile < ENERGY_TILE_MAX
           and -(-S // (2 * tile)) * groups >= 4 * sms):
        tile *= 2
    return tile, -(-C // groups)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64, device=device).contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, copied if its data is not 16-byte aligned (the kernels stage
    16-byte pieces)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _max_banks(nbanks: torch.Tensor) -> int:
    """The largest bank count (0 for none), read back in one host sync;
    raises unless every count is an integer in [1, MAX_BANKS]."""
    if not len(nbanks):
        return 0
    lo, hi = torch.aminmax(nbanks)
    lo, hi, frac = torch.stack([lo, hi, nbanks.frac().abs().amax()]).tolist()
    if not (lo >= 1 and hi <= MAX_BANKS and frac == 0):
        raise ValueError(f"bank counts must be integers in [1, {MAX_BANKS}]")
    return int(hi)


def running_time(durations: torch.Tensor) -> torch.Tensor:
    """(S + 1,) f64 [0, d0, d0 + d1, ...], added in order, bit for bit
    `np.r_[0, np.cumsum(d)]`, on `durations`'s device."""
    d = _f64(durations, durations.device)
    if d.device.type != "cuda":
        return ref.running_time(d)
    cum = torch.empty(len(d) + 1, dtype=torch.float64, device=d.device)
    if len(d) == 0:
        return cum.zero_()
    SCAN(build.ptr(_aligned(d)), build.ptr(cum), len(d), build.stream_ptr(d))
    return cum


def bank_activity_stats(durations: torch.Tensor, occupancy: torch.Tensor,
                        usable: torch.Tensor,
                        nbanks: torch.Tensor) -> torch.Tensor:
    """(C, 2) f64 per candidate: [active bank-seconds, on/off toggles].
    All inputs are tensors on one device; durations/occupancy are (S,),
    usable/nbanks (C,)."""
    dev = durations.device
    d, o = _f64(durations, dev), _f64(occupancy, dev)
    u, nb = _f64(usable, dev), _f64(nbanks, dev)
    if dev.type != "cuda":
        return bank_energy_ref(d, o, u, nb)
    S, C = len(d), len(u)
    if C == 0 or S == 0:
        _max_banks(nb)
        return torch.zeros((C, 2), dtype=torch.float64, device=dev)
    tile, group = energy_plan(S, C, _sm_count(dev.index or 0))
    part = torch.empty(C * -(-S // tile) * 2, dtype=torch.float64,
                       device=dev)
    out = torch.empty((C, 2), dtype=torch.float64, device=dev)
    BOUND(build.ptr(o), build.ptr(d), build.ptr(u), build.ptr(nb),
          build.ptr(part), build.ptr(out), S, C, tile, group,
          build.stream_ptr(d))
    # the kernel indexes nothing by a bank count: they are checked while it
    # runs
    _max_banks(nb)
    return out


def exact_bank_stats(durations: torch.Tensor, occupancy: torch.Tensor,
                     usable: torch.Tensor, nbanks: torch.Tensor,
                     threshold: torch.Tensor,
                     cum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(C, 5) f64 exact idle-run stats per candidate: [active bank-seconds,
    idle runs >= threshold, their seconds, idle runs < threshold, their
    seconds]. Same semantics as the reference's `exact_bank_stats_np`.
    `cum`, when given, is the trace's `running_time(durations)`; without
    it the call computes it."""
    dev = durations.device
    d, o = _f64(durations, dev), _f64(occupancy, dev)
    u, nb, th = _f64(usable, dev), _f64(nbanks, dev), _f64(threshold, dev)
    S, C = len(d), len(u)
    if cum is not None:
        cum = _f64(cum, dev)
        if tuple(cum.shape) != (S + 1,):
            raise ValueError(f"cum must be the (S + 1,) = ({S + 1},) "
                             f"running time, got {tuple(cum.shape)}")
    if dev.type != "cuda":
        return exact_bank_stats_ref(d, o, u, nb, th)
    if S >= 2**31 - 1:
        raise ValueError(f"exact_bank_stats: {S} segments; positions are "
                         "int32")
    if C == 0 or S == 0:
        _max_banks(nb)
        return torch.zeros((C, 5), dtype=torch.float64, device=dev)
    o, d = _aligned(o), _aligned(d)
    # the scan needs no bank count: it is queued before they are read back,
    # and the walk's scratch is sized by the largest
    cum = running_time(d) if cum is None else _aligned(cum)
    bmax = _max_banks(nb)
    G, W, chunk, Q = walk_plan(S, C, bmax, _sm_count(dev.index or 0))
    # each chunk's last fall and open rise per (candidate, bank)
    summary = torch.empty((2, C * bmax * Q), dtype=torch.int32, device=dev)
    part = torch.empty(C * Q * 5, dtype=torch.float64, device=dev)
    out = torch.empty((C, 5), dtype=torch.float64, device=dev)
    EXACT(build.ptr(o), build.ptr(d), build.ptr(cum), build.ptr(u),
          build.ptr(nb), build.ptr(th), build.ptr(summary[0]),
          build.ptr(summary[1]), build.ptr(part), build.ptr(out), S, C,
          bmax, G, W, chunk, Q, build.stream_ptr(d))
    return out
