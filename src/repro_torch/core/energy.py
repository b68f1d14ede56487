"""On-chip energy assembly (paper Fig. 7): PE dynamic/static, SRAM dynamic +
leakage (unbanked baseline, consistent with Stage II's B=1 candidate), DRAM.
A copy of the reference package's `repro/core/energy.py`."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.cacti import characterize
from repro_torch.sim.accelerator import AcceleratorConfig
from repro_torch.sim.engine import SimResult


@dataclass
class EnergyBreakdown:
    pe_dynamic: float
    pe_static: float
    sram_dynamic: float
    sram_leakage: float
    dram: float

    @property
    def total(self) -> float:
        return (self.pe_dynamic + self.pe_static + self.sram_dynamic
                + self.sram_leakage + self.dram)

    def as_dict(self) -> Dict[str, float]:
        return {"pe_dynamic": self.pe_dynamic, "pe_static": self.pe_static,
                "sram_dynamic": self.sram_dynamic,
                "sram_leakage": self.sram_leakage, "dram": self.dram,
                "total": self.total}


def assemble_energy(sim: SimResult, accel: AcceleratorConfig) -> EnergyBreakdown:
    T = sim.total_time
    pe_dyn = (sim.total_macs * accel.e_mac_pj
              + sim.total_vector_ops * accel.e_vop_pj) * 1e-12
    pe_static = accel.pe_static_w * T

    sram_dyn = 0.0
    sram_leak = 0.0
    for m in accel.memories:
        if m.name == accel.dram_name:
            continue
        ch = characterize(m.capacity, 1)
        sram_dyn += (sim.access.n_reads(m.name) * ch.e_read_j
                     + sim.access.n_writes(m.name) * ch.e_write_j)
        sram_leak += ch.leak_w_total * T

    dram_bytes = (sim.access.reads_bytes.get(accel.dram_name, 0)
                  + sim.access.writes_bytes.get(accel.dram_name, 0))
    dram = dram_bytes * accel.e_dram_pj_per_byte * 1e-12
    return EnergyBreakdown(pe_dyn, pe_static, sram_dyn, sram_leak, dram)
