"""Policy sensitivity studies + drowsy (multi-state) retention — the paper's
stated future work ("more detailed transition overhead models and policy
sensitivity studies", Sec. V). A copy of the reference package's
`repro/core/sensitivity.py`; `policy_sensitivity` runs its batched call on
`device` (the CUDA bank-energy kernels on the card).

Drowsy mode (Flautner et al., ISCA'02 — the paper's ref [12]): instead of
fully gating a bank (state lost, wake-up latency ~1 us), drop it to a
retention voltage: ~70-85% leakage reduction, data retained, ~2-cycle wake.
For banks holding *obsolete* data full gating is free; for banks that will be
needed again soon, drowsy avoids the refetch/wake cost. We model a three-state
policy: ON / DROWSY (short idle) / OFF (idle >= break-even).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np

from repro_torch.core.banking import bank_activity, bank_on_matrix, idle_runs
from repro_torch.core.cacti import characterize

DROWSY_LEAK_FRACTION = 0.25          # retention-voltage leakage vs ON
DROWSY_SWITCH_FRACTION = 0.02        # transition energy vs full PG pair


@dataclass
class DrowsyResult:
    e_dyn: float
    e_leak_on: float
    e_leak_drowsy: float
    e_sw: float
    n_off: int
    n_drowsy: int

    @property
    def e_total(self) -> float:
        return self.e_dyn + self.e_leak_on + self.e_leak_drowsy + self.e_sw


def evaluate_drowsy(durations: np.ndarray, occupancy: np.ndarray, *,
                    capacity: int, banks: int, alpha: float = 0.9,
                    n_reads: int = 0, n_writes: int = 0,
                    off_multiple: float = 1.0,
                    e_switch_scale: float = 1.0) -> DrowsyResult:
    """Three-state policy: idle interval < break-even -> DROWSY; otherwise
    OFF. Active segments are ON.

    This is the *scalar reference* implementation (per-bank Python loops);
    the batched engine (`core.candidates.evaluate_candidates` with
    policy="drowsy") is property-tested against it and is what sweeps and
    CLIs use. `e_switch_scale` mirrors the `characterize` sensitivity hook
    so scaled-transition candidates keep a scalar reference too."""
    ch = characterize(capacity, banks, e_switch_scale)
    d = np.asarray(durations, np.float64)
    act = bank_activity(occupancy, alpha, capacity, banks)
    on = bank_on_matrix(act, banks)
    threshold = off_multiple * ch.break_even_s

    e_dyn = n_reads * ch.e_read_j + n_writes * ch.e_write_j
    on_seconds = float((on * d[:, None]).sum())
    drowsy_seconds = 0.0
    off_seconds = 0.0
    n_off = 0
    n_drowsy = 0
    for b in range(banks):
        run_d, starts, ends = idle_runs(d, on[:, b])
        off = run_d >= threshold
        n_off += int(off.sum())
        n_drowsy += int((~off).sum())
        off_seconds += float(run_d[off].sum())
        drowsy_seconds += float(run_d[~off].sum())

    p = ch.leak_w_per_bank
    return DrowsyResult(
        e_dyn=e_dyn,
        e_leak_on=p * on_seconds,
        e_leak_drowsy=p * DROWSY_LEAK_FRACTION * drowsy_seconds,
        e_sw=(n_off * ch.e_switch_j
              + n_drowsy * ch.e_switch_j * DROWSY_SWITCH_FRACTION),
        n_off=n_off, n_drowsy=n_drowsy)


def policy_sensitivity(durations: np.ndarray, occupancy: np.ndarray, *,
                       capacity: int, banks: int,
                       n_reads: int, n_writes: int,
                       multiples: Sequence[float] = (1.0, 1e2, 1e3, 1e4, 1e5),
                       sw_scales: Sequence[float] = (0.1, 1.0, 10.0, 100.0),
                       device="cuda") -> Dict[str, Dict[float, float]]:
    """How robust are Stage-II conclusions to (a) the gating threshold and
    (b) the per-transition energy assumption? Returns E_tot per setting.

    The threshold grid, the transition-energy grid (via the
    `characterize(..., e_switch_scale=)` hook, which scales E_sw and the
    implied break-even together) and the drowsy grid are one batched
    `evaluate_candidates` call on `device`."""
    from repro_torch.core.candidates import Candidate, evaluate_candidates
    cap, b = int(capacity), int(banks)
    cands = (
        [Candidate(cap, b, 0.9, "gate", m, label="sens") for m in multiples]
        + [Candidate(cap, b, 0.9, "gate", 1.0, e_switch_scale=s,
                     label="sens") for s in sw_scales]
        + [Candidate(cap, b, 0.9, "drowsy", m) for m in multiples])
    res = evaluate_candidates(durations, occupancy, cands, n_reads=n_reads,
                              n_writes=n_writes, device=device)
    n_m, n_s = len(multiples), len(sw_scales)
    return {
        "threshold": {m: float(res.e_total[i])
                      for i, m in enumerate(multiples)},
        "sw_scale": {s: float(res.e_total[n_m + i])
                     for i, s in enumerate(sw_scales)},
        "drowsy": {m: float(res.e_total[n_m + n_s + i])
                   for i, m in enumerate(multiples)},
    }
