"""Stage-II trace analytics: dispatch between the CUDA kernels and their
plain versions.

Ports `repro/kernels/bank_energy/ops.py`. Two entry points, each evaluating a
whole (C, B, alpha) candidate grid in one call:

  * `bank_activity_stats` — lower-bound stats (bank-seconds, toggles), the
    kernel `bank_energy` (replaces the TPU `bank_energy_kernel`);
  * `exact_bank_stats`    — exact idle-run stats, the kernel
    `exact_bank_stats` (replaces the TPU `exact_bank_stats_kernel`).

Both take float64 inputs and accumulate in float64: occupancy is byte-valued
and passes 2^24 for the paper's 128 MiB arrays, and the reference's float32
path drifts on traces of microsecond segments. On a CUDA tensor a wrapper
launches its kernel (`csrc/bank_energy.cu`) or raises; on a CPU tensor it
runs the plain version in `ref.py`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.bank_energy.ref import (bank_energy_ref,
                                                 exact_bank_stats_ref)

MAX_BANKS = 256     # one walking lane per bank in a 256-thread block

_P = ctypes.c_void_p
EXACT = build.register(build.CudaKernel(
    "exact_bank_stats", "bank_energy", "exact_bank_stats_f64",
    [_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P]))
BOUND = build.register(build.CudaKernel(
    "bank_energy", "bank_energy", "bank_energy_f64",
    [_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P]))


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64, device=device).contiguous()


def _check_banks(nbanks: torch.Tensor) -> None:
    if len(nbanks) and not bool(
            ((nbanks >= 1) & (nbanks <= MAX_BANKS)
             & (nbanks == nbanks.round())).all()):
        raise ValueError(f"bank counts must be integers in [1, {MAX_BANKS}]")


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
    _check_banks(nb)
    out = torch.zeros((len(u), 2), dtype=torch.float64, device=dev)
    if len(u) == 0 or len(d) == 0:
        return out
    BOUND(build.ptr(o), build.ptr(d), build.ptr(u), build.ptr(nb),
          build.ptr(out), len(d), len(u), build.stream_ptr(d))
    return out


def exact_bank_stats(durations: torch.Tensor, occupancy: torch.Tensor,
                     usable: torch.Tensor, nbanks: torch.Tensor,
                     threshold: torch.Tensor) -> torch.Tensor:
    """(C, 5) f64 exact idle-run stats per candidate: [active bank-seconds,
    idle runs >= threshold, their seconds, idle runs < threshold, their
    seconds]. Same semantics as the reference's `exact_bank_stats_np`."""
    dev = durations.device
    d, o = _f64(durations, dev), _f64(occupancy, dev)
    u, nb, th = _f64(usable, dev), _f64(nbanks, dev), _f64(threshold, dev)
    if dev.type != "cuda":
        return exact_bank_stats_ref(d, o, u, nb, th)
    _check_banks(nb)
    out = torch.zeros((len(u), 5), dtype=torch.float64, device=dev)
    if len(u) == 0 or len(d) == 0:
        return out
    cum = torch.empty(len(d) + 1, dtype=torch.float64, device=dev)
    EXACT(build.ptr(o), build.ptr(d), build.ptr(u), build.ptr(nb),
          build.ptr(th), build.ptr(cum), build.ptr(out), len(d), len(u),
          build.stream_ptr(d))
    return out
