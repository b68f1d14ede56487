"""Accelerator templates for the Stage-I simulator (paper Fig. 4 / Fig. 10);
a copy of the reference package's `repro/sim/accelerator.py`.

Baseline: four 128x128 systolic arrays @ 1 GHz (one 8-bit MAC/cycle/PE =
65.5 TMAC/s peak), per-array row/column FIFOs, one shared on-chip SRAM
(128 MiB, 512-bit interface, 4 ports, 32 ns) over a 2 GiB DRAM (2 ports,
80 ns). The multi-level variant (Sec. IV-D) adds two dedicated memories, each
private to a pair of systolic arrays, with the shared SRAM as backup/staging.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class MemConfig:
    name: str
    capacity: int                 # bytes
    ports: int
    width_bits: int
    latency_ns: float
    # effective fraction of peak port bandwidth actually sustained (FIFO
    # bubbles, bank conflicts, refill turnaround). Calibrated in DESIGN.md §8.
    bw_derate: float = 1.0

    @property
    def peak_bw(self) -> float:   # bytes/sec at 1 GHz port clock
        return self.ports * (self.width_bits / 8) * 1e9

    @property
    def eff_bw(self) -> float:
        return self.peak_bw * self.bw_derate


def sram_latency_ns(capacity: int) -> float:
    """CACTI-flavoured access latency vs capacity (paper: 32 ns @128 MiB,
    22 ns @64 MiB). Fit: latency ~ a * sqrt(C) + b."""
    mib = capacity / 2**20
    return 2.75 * math.sqrt(mib) + 0.9


@dataclass(frozen=True)
class AcceleratorConfig:
    name: str = "trapti-base"
    sa_count: int = 4
    sa_dim: int = 128
    freq_hz: float = 1.0e9
    vpu_lanes: int = 512          # vector element-ops per cycle per array
    fifo_depth: int = 256         # entries per lane (timing folded into derate)
    memories: Tuple[MemConfig, ...] = (
        MemConfig("sram", 128 * 2**20, 4, 512, 32.0, bw_derate=0.45),
        MemConfig("dram", 2 * 2**30, 2, 512, 80.0, bw_derate=0.70),
    )
    # memory each SA is attached to (reads operands / writes results there)
    sa_memory: Tuple[str, ...] = ("sram", "sram", "sram", "sram")
    dram_name: str = "dram"

    # ---- energy constants (45 nm, int8; calibration notes in DESIGN.md) ----
    e_mac_pj: float = 0.45        # per int8 MAC
    e_vop_pj: float = 0.15        # per vector element-op
    pe_static_w: float = 30.0     # PE array + NoC + FIFOs static power
    e_dram_pj_per_byte: float = 20.0

    def mem(self, name: str) -> MemConfig:
        for m in self.memories:
            if m.name == name:
                return m
        raise KeyError(name)

    @property
    def onchip_names(self) -> List[str]:
        return [m.name for m in self.memories if m.name != self.dram_name]

    @property
    def peak_macs_per_s(self) -> float:
        return self.sa_count * self.sa_dim * self.sa_dim * self.freq_hz

    def with_sram_capacity(self, capacity: int) -> "AcceleratorConfig":
        mems = tuple(
            replace(m, capacity=capacity, latency_ns=sram_latency_ns(capacity))
            if m.name == "sram" else m
            for m in self.memories)
        return replace(self, memories=mems)


def baseline_accelerator(sram_mib: int = 128) -> AcceleratorConfig:
    cfg = AcceleratorConfig()
    return cfg.with_sram_capacity(sram_mib * 2**20)


def multilevel_accelerator(mib: int = 64) -> AcceleratorConfig:
    """Sec. IV-D: shared SRAM + two dedicated memories (one per SA pair)."""
    cap = mib * 2**20
    lat = sram_latency_ns(cap)
    mems = (
        MemConfig("sram", cap, 4, 512, lat, bw_derate=0.45),
        MemConfig("dm1", cap, 4, 512, lat, bw_derate=0.45),
        MemConfig("dm2", cap, 4, 512, lat, bw_derate=0.45),
        MemConfig("dram", 2 * 2**30, 2, 512, 80.0, bw_derate=0.70),
    )
    return AcceleratorConfig(
        name="trapti-multilevel",
        memories=mems,
        sa_memory=("dm1", "dm1", "dm2", "dm2"),
    )
