"""Power-gating policies + Eq. (2)-(5) energy model (TRAPTI Stage II); a
copy of the reference package's `repro/core/gating.py`.

    E_tot = E_dyn + E_leak + E_sw                                  (2)
    E_dyn = N_R * E_R + N_W * E_W                                  (3)
    E_leak ~= sum_k P_leak_bank * B_on(k) * dt_k                   (4)
    E_sw  = N_sw * E_sw_bank                                       (5)

Policies:
  * "none"         — no gating; all B banks leak for the whole run.
  * "aggressive"   — alpha = 1.0 packing; gate every idle-eligible interval
                     that passes the break-even criterion.
  * "conservative" — alpha = 0.9 headroom; additionally skip idle intervals
                     shorter than `min_gate_multiple` x break-even (avoids
                     thrashing and wake-up latency exposure).
  * "drowsy"       — three-state ON/DROWSY/OFF: idle intervals >= the gate
                     threshold fully gate as usual, shorter ones drop to a
                     retention voltage (`drowsy_fraction` of full leakage,
                     `drowsy_switch_fraction` of a full switch per run) —
                     the Flautner-style policy `sensitivity.evaluate_drowsy`
                     models, expressed as a `Policy` so the streaming
                     energy meter can run it online.

`evaluate` is the *scalar reference*: one candidate at a time, per-bank
Python loops. Sweeps, campaigns and CLIs run on the batched engine
(`core.candidates.evaluate_candidates`), which is property-tested against
this function and evaluates the whole (C, B, alpha, policy) grid in one
vectorized call.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional

import numpy as np

from repro_torch.core.banking import bank_activity, bank_on_matrix, idle_runs
from repro_torch.core.cacti import SramCharacterization, characterize


@dataclass(frozen=True)
class Policy:
    name: str
    alpha: float
    gate: bool
    min_gate_multiple: float = 1.0      # x break-even time
    # three-state retention knobs: idle runs *below* the gate threshold leak
    # at `drowsy_fraction` of full power (1.0 = stay fully ON, the classic
    # two-state policies) and cost `drowsy_switch_fraction` of a full
    # power-gate switch per run (0.0 = no transition). The defaults make the
    # new terms exact no-ops, so pre-existing policies are bit-identical.
    drowsy_fraction: float = 1.0
    drowsy_switch_fraction: float = 0.0

    @staticmethod
    def none(alpha: float = 1.0) -> "Policy":
        return Policy("none", alpha, gate=False)

    @staticmethod
    def aggressive() -> "Policy":
        return Policy("aggressive", 1.0, gate=True, min_gate_multiple=1.0)

    @staticmethod
    def conservative(alpha: float = 0.9) -> "Policy":
        return Policy("conservative", alpha, gate=True, min_gate_multiple=5.0)

    @staticmethod
    def drowsy(alpha: float = 0.9, off_multiple: float = 1.0) -> "Policy":
        from repro_torch.core.sensitivity import (DROWSY_LEAK_FRACTION,
                                            DROWSY_SWITCH_FRACTION)
        return Policy("drowsy", alpha, gate=True,
                      min_gate_multiple=off_multiple,
                      drowsy_fraction=DROWSY_LEAK_FRACTION,
                      drowsy_switch_fraction=DROWSY_SWITCH_FRACTION)

    @staticmethod
    def by_name(name: str, alpha: Optional[float] = None) -> "Policy":
        """Resolve a CLI policy spelling; `alpha` overrides the default."""
        table = {"none": Policy.none(), "aggressive": Policy.aggressive(),
                 "conservative": Policy.conservative(),
                 "drowsy": Policy.drowsy()}
        if name not in table:
            raise ValueError(f"unknown policy {name!r}; "
                             f"choose from {sorted(table)}")
        p = table[name]
        if alpha is not None and alpha != p.alpha:
            p = replace(p, alpha=alpha)
        return p


@dataclass
class GatingResult:
    policy: str
    alpha: float
    capacity: int
    banks: int
    e_dyn: float
    e_leak: float
    e_sw: float
    n_transitions: int
    gated_bank_seconds: float
    total_bank_seconds: float
    area_mm2: float
    # three-state extras (zero for the classic two-state policies)
    drowsy_bank_seconds: float = 0.0
    n_drowsy: int = 0

    @property
    def e_total(self) -> float:
        return self.e_dyn + self.e_leak + self.e_sw


def evaluate(durations: np.ndarray, occupancy: np.ndarray, *,
             capacity: int, banks: int, policy: Policy,
             n_reads: int, n_writes: int,
             char: Optional[SramCharacterization] = None) -> GatingResult:
    """Offline Stage-II evaluation of one (C, B, policy) candidate against a
    Stage-I occupancy trace (same execution schedule, per the paper)."""
    ch = char or characterize(capacity, banks)
    d = np.asarray(durations, np.float64)
    total_time = float(d.sum())

    e_dyn = n_reads * ch.e_read_j + n_writes * ch.e_write_j

    if not policy.gate:
        e_leak = ch.leak_w_per_bank * banks * total_time
        return GatingResult(policy.name, policy.alpha, capacity, banks,
                            e_dyn, e_leak, 0.0, 0, 0.0, banks * total_time,
                            ch.area_mm2)

    act = bank_activity(occupancy, policy.alpha, capacity, banks)
    on = bank_on_matrix(act, banks)                     # (nseg, B)
    threshold = policy.min_gate_multiple * ch.break_even_s

    # a bank is ON while required AND during idle intervals too short to gate
    drowsy = (policy.drowsy_fraction != 1.0
              or policy.drowsy_switch_fraction != 0.0)
    gated_seconds = 0.0
    drowsy_seconds = 0.0
    n_sw = 0
    n_drowsy = 0
    on_final = np.ones_like(on)
    for b in range(banks):
        run_d, starts, ends = idle_runs(d, on[:, b])
        ok = run_d >= threshold
        n_sw += int(ok.sum())
        gated_seconds += float(run_d[ok].sum())
        for s, e in zip(starts[ok], ends[ok]):
            on_final[s:e, b] = False
        if drowsy:
            n_drowsy += int((~ok).sum())
            drowsy_seconds += float(run_d[~ok].sum())

    on_seconds = float((on_final * d[:, None]).sum())
    e_leak = ch.leak_w_per_bank * on_seconds
    e_sw = n_sw * ch.e_switch_j
    if drowsy:
        # short idle runs drop to retention voltage instead of staying fully
        # ON: swap their full-leak share for the retention fraction and pay
        # the (cheap) drowsy transition per run
        e_leak += ((policy.drowsy_fraction - 1.0) * ch.leak_w_per_bank
                   * drowsy_seconds)
        e_sw += n_drowsy * ch.e_switch_j * policy.drowsy_switch_fraction
    return GatingResult(policy.name, policy.alpha, capacity, banks,
                        e_dyn, e_leak, e_sw, n_sw, gated_seconds,
                        banks * total_time, ch.area_mm2,
                        drowsy_bank_seconds=drowsy_seconds,
                        n_drowsy=n_drowsy)


def bank_timeline(durations: np.ndarray, occupancy: np.ndarray, *,
                  capacity: int, banks: int, alpha: float) -> Dict[str, np.ndarray]:
    """Fig.-8 style artifact: per-segment activity + packing overhead."""
    act = bank_activity(occupancy, alpha, capacity, banks)
    usable = alpha * capacity / banks
    overhead = act * (capacity / banks) - np.minimum(
        act * usable, np.asarray(occupancy, np.float64))
    return {
        "durations": np.asarray(durations, np.float64),
        "occupancy": np.asarray(occupancy, np.float64),
        "active_banks": act,
        "placement_overhead_bytes": np.maximum(overhead, 0.0),
    }
