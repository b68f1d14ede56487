"""Roofline terms of a dry-run cell on the NVIDIA H100 (no hardware needed);
port of the reference's `repro/launch/roofline.py` with the card's
constants in place of the TPU's.

Terms per (arch x shape x mesh), per device:
    compute    = FLOPs_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / LINK_BW

The port has no compiler's cost analysis or HLO: the FLOPs and bytes come
from the dry run's count of the plain step (`launch/dryrun.py`), and the
collective bytes from its per-collective records, which follow rules over
the placements (`collective_bytes` sums them per kind).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

# NVIDIA H100 SXM5 data sheet (H100 Tensor Core GPU, SXM5 form factor),
# dense rates without sparsity, for a card at its full power limit, as
# `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
# it: "NVIDIA H100 80GB HBM3, 700.00 W".
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
LINK_BW = 450e9              # NVLink bytes/s per direction (900 GB/s total)

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")


def collective_bytes(records: Iterable[Tuple[str, float]]) -> Dict[str, int]:
    """Per-device bytes by collective kind, summed from (kind, bytes per
    device) records; every kind of `COLLECTIVE_OPS` is present."""
    out: Dict[str, int] = {k: 0 for k in COLLECTIVE_OPS}
    for kind, nbytes in records:
        if kind not in out:
            raise ValueError(f"unknown collective {kind!r}")
        out[kind] += int(nbytes)
    return out


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, int] = field(default_factory=dict)
    model_flops_total: float = 0.0
    peak_memory_per_device: Optional[float] = None
    min_bytes_per_device: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs x chips): remat/redundancy waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def t_min_memory(self) -> float:
        """Analytic lower bound on HBM time: bytes that MUST move (weights,
        KV/state, batch io) even with perfect fusion."""
        return self.min_bytes_per_device / HBM_BW

    @property
    def t_ideal(self) -> float:
        """The larger of the useful-FLOPs bound and the mandatory-bytes
        bound (decode is legitimately bandwidth-bound: reading the weights
        and KV once is the roofline, not the tensor cores)."""
        return max((self.model_flops_total / self.chips) / PEAK_FLOPS,
                   self.t_min_memory)

    @property
    def roofline_fraction(self) -> float:
        """Headline score: ideal time / modeled bound time."""
        if self.bound_time <= 0:
            return 0.0
        return min(self.t_ideal / self.bound_time, 1.0)

    def row(self) -> str:
        return (f"{self.arch:24s} {self.shape:12s} {self.mesh:6s} "
                f"{self.t_compute*1e3:9.2f} {self.t_memory*1e3:9.2f} "
                f"{self.t_collective*1e3:9.2f} {self.dominant:10s} "
                f"{self.useful_flops_ratio:6.2f} "
                f"{self.roofline_fraction*100:6.1f}%")

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
            "model_flops_total": self.model_flops_total,
            "t_compute_ms": self.t_compute * 1e3,
            "t_memory_ms": self.t_memory * 1e3,
            "t_collective_ms": self.t_collective * 1e3,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_memory_per_device": self.peak_memory_per_device,
            "min_bytes_per_device": self.min_bytes_per_device,
            "t_min_memory_ms": self.t_min_memory * 1e3,
            "t_ideal_ms": self.t_ideal * 1e3,
        }


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS for the cell (6ND train / 2ND inference; MoE uses
    active params; decode processes one token per sequence)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence + attention reads over the KV length
    tokens = shape.global_batch
    flops = 2.0 * n_active * tokens
    if cfg.num_heads:
        ctx = shape.seq_len
        if cfg.local_window:
            kinds = cfg.layer_kinds()
            n_local = sum(1 for k in kinds if k in ("local", "chunked"))
            n_full = sum(1 for k in kinds if k == "full")
            eff_layers = n_full + n_local * min(
                1.0, cfg.local_window / max(ctx, 1))
        else:
            eff_layers = sum(1 for k in cfg.layer_kinds()
                             if k in ("full", "local", "chunked"))
        flops += (4.0 * tokens * ctx * cfg.num_kv_heads * cfg.head_dim
                  * eff_layers)
    return flops


def min_hbm_bytes(cfg, shape, chips: int) -> float:
    """Mandatory per-device HBM traffic per step (perfect-fusion floor)."""
    if shape.kind == "train":
        # fp32 params read+write, m/v read+write, bf16 batch io, one
        # activation checkpoint per layer each way
        w = cfg.param_count() * 4.0 * 6.0
        act = (shape.global_batch * shape.seq_len * cfg.d_model * 2.0
               * cfg.num_layers * 2.0)
        return (w + act) / chips
    w = cfg.active_param_count() * 2.0
    if shape.kind == "prefill":
        act = (shape.global_batch * shape.seq_len * cfg.d_model * 2.0
               * cfg.num_layers)
        return (w + act) / chips
    # decode: weights + the KV cache / recurrent state read once
    kv = 0.0
    if cfg.num_heads:
        for kind in cfg.layer_kinds():
            if kind == "full":
                ctx = shape.seq_len
            elif kind in ("local", "chunked"):
                ctx = min(cfg.local_window or shape.seq_len, shape.seq_len)
            else:
                continue
            kv += 2.0 * shape.global_batch * ctx * cfg.kv_dim * 2.0
    if cfg.ssm is not None:
        s = cfg.ssm
        kv += (shape.global_batch * s.num_heads(cfg.d_model) * s.head_dim
               * s.state_dim * 4.0 * cfg.num_layers)
    return (w + kv) / chips


def ideal_seconds(cfg, shape, chips: int = 1) -> float:
    """The roofline's ideal time of a cell on `chips` cards
    (`RooflineReport.t_ideal` of its model FLOPs and mandatory bytes)."""
    return build_report(cfg.name, shape.name, "", chips, {}, (),
                        model_flops(cfg, shape),
                        min_bytes=min_hbm_bytes(cfg, shape, chips)).t_ideal


def build_report(arch_name: str, shape_name: str, mesh_label: str,
                 chips: int, cost: dict, records: Iterable[Tuple[str, float]],
                 model_flops_total: float,
                 peak_mem: Optional[float] = None,
                 min_bytes: float = 0.0) -> RooflineReport:
    coll = collective_bytes(records)
    return RooflineReport(
        arch=arch_name, shape=shape_name, mesh=mesh_label, chips=chips,
        flops_per_device=float(cost.get("flops", 0.0)),
        bytes_per_device=float(cost.get("bytes accessed", 0.0)),
        coll_bytes_per_device=float(sum(coll.values())),
        coll_breakdown=coll,
        model_flops_total=model_flops_total,
        peak_memory_per_device=peak_mem,
        min_bytes_per_device=min_bytes)


HEADER = (f"{'arch':24s} {'shape':12s} {'mesh':6s} {'t_comp ms':>9} "
          f"{'t_mem ms':>9} {'t_coll ms':>9} {'dominant':10s} {'useful':>6} "
          f"{'roofl%':>7}")
