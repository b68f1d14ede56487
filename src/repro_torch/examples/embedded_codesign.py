"""Embedded co-design sweep: for any architecture in the zoo, find the minimum
SRAM (Stage-I sizing loop), then recommend a banking + power-gating
configuration (Stage II, on `--device`) — the paper's methodology as a
framework feature. Counterpart of the reference's
`examples/embedded_codesign.py`.

Run:  PYTHONPATH=src python -m repro_torch.examples.embedded_codesign \
          --arch olmoe-1b-7b
      PYTHONPATH=src python -m repro_torch.examples.embedded_codesign --all \
          --device cpu
"""
import argparse

from repro_torch.configs import ASSIGNED_ARCHS, get_arch
from repro_torch.core.explorer import sweep
from repro_torch.core.workload import build_graph
from repro_torch.device import require_device
from repro_torch.sim.accelerator import baseline_accelerator
from repro_torch.sim.engine import find_min_sram

MIB = 2**20


def codesign(arch: str, M: int = 2048, device="cuda") -> str:
    cfg = get_arch(arch)
    graph = build_graph(cfg, M=M, subops=4)
    mib, sim = find_min_sram(graph, baseline_accelerator(128),
                             lo_mib=16, hi_mib=256, step_mib=16)
    trace = sim.traces["sram"]
    table = sweep(sim, capacities_mib=[mib],
                  banks=(1, 2, 4, 8, 16, 32), device=device)
    best = table.best()
    return (f"{arch:24s} minSRAM={mib:4d}MiB "
            f"peak={trace.peak_needed()/MIB:6.1f}MiB "
            f"t={sim.total_time*1e3:7.1f}ms util={sim.pe_utilization*100:4.1f}% "
            f"-> B={best.banks:2d} banks: {best.delta_e_pct:+.1f}% energy, "
            f"{best.delta_a_pct:+.1f}% area")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    device = require_device(args.device)

    archs = list(ASSIGNED_ARCHS) if args.all else [args.arch]
    print(f"TRAPTI co-design at M={args.seq} (alpha=0.9, conservative gating)")
    for a in archs:
        print(codesign(a, args.seq, device))


if __name__ == "__main__":
    main()
