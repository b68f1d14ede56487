"""Eq. (1) of the paper: map an occupancy trace to bank-level activity.

    B_act(t) = ceil( o(t) / (alpha * C / B) ),  0 <= B_act(t) <= B

Occupied data is assumed packed contiguously across banks; alpha in (0, 1]
reserves per-bank headroom for non-ideal placement (0.9 = the paper's
conservative guardband, 1.0 = aggressive).

A copy of the reference package's `repro/core/banking.py`: the scalar
reference of the port's batched bank-energy kernels
(`repro_torch.kernels.bank_energy`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def bank_activity(occ_bytes: np.ndarray, alpha: float, capacity: int,
                  banks: int) -> np.ndarray:
    """Per-segment number of banks that must stay powered. occ: int64 bytes."""
    if not (0.0 < alpha <= 1.0):
        raise ValueError(f"alpha must be in (0,1], got {alpha}")
    usable = alpha * (capacity / banks)
    act = np.ceil(np.asarray(occ_bytes, np.float64) / usable)
    return np.clip(act, 0, banks).astype(np.int32)


def active_bank_seconds(durations: np.ndarray, activity: np.ndarray) -> float:
    """Integral of B_act(t) dt — the Eq. (4) kernel."""
    return float(np.sum(np.asarray(durations, np.float64)
                        * np.asarray(activity, np.float64)))


def bank_on_matrix(activity: np.ndarray, banks: int) -> np.ndarray:
    """(n_segments, banks) boolean — bank b is required iff B_act > b
    (banks fill lowest-first under contiguous packing)."""
    return activity[:, None] > np.arange(banks)[None, :]


def idle_runs(durations: np.ndarray, on: np.ndarray):
    """Idle intervals of one bank: on is a boolean per-segment series.

    Returns (run_durations, run_start_idx, run_end_idx) for maximal runs of
    False."""
    on = np.asarray(on, bool)
    d = np.asarray(durations, np.float64)
    n = len(on)
    if n == 0:
        return np.zeros(0), np.zeros(0, np.int64), np.zeros(0, np.int64)
    idle = ~on
    # boundaries of idle runs
    diff = np.diff(idle.astype(np.int8))
    starts = np.flatnonzero(diff == 1) + 1
    ends = np.flatnonzero(diff == -1) + 1
    if idle[0]:
        starts = np.r_[0, starts]
    if idle[-1]:
        ends = np.r_[ends, n]
    cum = np.r_[0.0, np.cumsum(d)]
    run_d = cum[ends] - cum[starts]
    return run_d, starts, ends
