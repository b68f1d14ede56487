"""CACTI-7-like analytical SRAM surrogate (45 nm, itrs-hp); a copy of the
reference package's `repro/core/cacti.py`.

CACTI itself is a C++ binary we cannot run here; this surrogate is fit to the
paper's own Table II (which was produced with CACTI 7 at 45 nm itrs-hp), so
Stage II reproduces the paper's absolute scale:

  * leakage  — Table II B=1 rows are linear in C at fixed runtime:
               P_leak ≈ 0.682 W/MiB of cell array (+ periphery area leakage).
  * area     — linear cell area ≈ 16.78 mm²/MiB + 49.1 mm² + per-bank
               periphery ≈ 5.4·sqrt(bank_MiB) mm² (fit residual < 2.5%).
  * access   — wordline/bitline energy ~ sqrt(bank size) + H-tree routing
               ~ log2(B) (CACTI scaling shape, constants in the CACTI range).
  * gating   — sleep-transistor transition energy ~ 0.4 nJ/KiB of bank, giving
               break-even times well under 1 ms (the paper finds switching
               overhead negligible; we verify the same).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

MIB = float(2**20)

# --- calibrated constants (see DESIGN.md §8) --------------------------------
LEAK_W_PER_MIB = 0.682          # cell-array leakage
AREA_MM2_PER_MIB = 16.78
AREA_MM2_FIXED = 49.1
AREA_BANK_MM2_PER_SQRT_MIB = 5.4
LEAK_W_PER_MM2 = LEAK_W_PER_MIB / AREA_MM2_PER_MIB   # periphery leakage

E_ACC_BASE_NJ = 1.2             # per 64B access
E_ACC_SQRT_NJ = 0.35            # x sqrt(bank MiB)
E_ACC_ROUTE_NJ = 0.15           # x log2(B)

E_SW_NJ_PER_KIB = 0.4           # power-gate transition (off+on pair)
WAKEUP_LATENCY_NS = 1000.0


@dataclass(frozen=True)
class SramCharacterization:
    capacity: int                # bytes, total
    banks: int
    access_bytes: int = 64
    e_switch_scale: float = 1.0  # sensitivity hook: scales E_sw and break-even

    # ------------------------------------------------------------- derived
    @property
    def bank_bytes(self) -> int:
        return self.capacity // self.banks

    @property
    def bank_mib(self) -> float:
        return self.bank_bytes / MIB

    @property
    def cap_mib(self) -> float:
        return self.capacity / MIB

    # area ------------------------------------------------------------------
    @property
    def area_mm2(self) -> float:
        cell = AREA_MM2_PER_MIB * self.cap_mib + AREA_MM2_FIXED
        periphery = self.banks * AREA_BANK_MM2_PER_SQRT_MIB * math.sqrt(
            max(self.bank_mib, 1e-9))
        return cell + periphery

    # leakage ----------------------------------------------------------------
    @property
    def leak_w_total(self) -> float:
        """All banks on."""
        return self.banks * self.leak_w_per_bank

    @property
    def leak_w_per_bank(self) -> float:
        cell = LEAK_W_PER_MIB * self.bank_mib
        periphery = (AREA_BANK_MM2_PER_SQRT_MIB
                     * math.sqrt(max(self.bank_mib, 1e-9))) * LEAK_W_PER_MM2
        return cell + periphery

    # dynamic ----------------------------------------------------------------
    @property
    def e_read_j(self) -> float:
        nj = (E_ACC_BASE_NJ + E_ACC_SQRT_NJ * math.sqrt(max(self.bank_mib, 1e-9))
              + E_ACC_ROUTE_NJ * math.log2(max(self.banks, 1)))
        return nj * 1e-9

    @property
    def e_write_j(self) -> float:
        return 1.1 * self.e_read_j          # writes slightly costlier (CACTI)

    # power gating -------------------------------------------------------------
    @property
    def e_switch_j(self) -> float:
        """Energy of one off->on transition pair for one bank."""
        return (E_SW_NJ_PER_KIB * (self.bank_bytes / 1024) * 1e-9
                * self.e_switch_scale)

    @property
    def break_even_s(self) -> float:
        """Idle duration above which gating one bank saves net energy."""
        return self.e_switch_j / max(self.leak_w_per_bank, 1e-12)

    @property
    def access_latency_ns(self) -> float:
        from repro_torch.sim.accelerator import sram_latency_ns
        return sram_latency_ns(self.bank_bytes) + 0.3 * math.log2(
            max(self.banks, 1))


@functools.lru_cache(maxsize=None)
def characterize(capacity_bytes: int, banks: int,
                 e_switch_scale: float = 1.0) -> SramCharacterization:
    """Memoized: sweeps/campaigns re-characterize identical (C, B) cells
    thousands of times; the instance is frozen, so sharing it is safe.

    `e_switch_scale` scales the per-transition energy *and* the implied
    break-even time — the sensitivity-study hook (replaces ad-hoc
    subclassing of `SramCharacterization`)."""
    return SramCharacterization(int(capacity_bytes), int(banks),
                                e_switch_scale=float(e_switch_scale))
