"""Quickstart: the TRAPTI two-stage flow in ~40 lines; counterpart of the
reference's `examples/quickstart.py`.

Stage I  — cycle-level simulation of DeepSeek-R1-Distill-Qwen-1.5B (GQA) and
           GPT-2 XL (MHA) on the paper's accelerator (4x 128x128 SAs, shared
           SRAM), extracting time-resolved occupancy traces (host code).
Stage II — offline banking + power-gating exploration on those traces, on
           `--device` (the CUDA bank-energy kernels on the card).

Run on the card:   PYTHONPATH=src python -m repro_torch.examples.quickstart
Run on the CPU:    PYTHONPATH=src python -m repro_torch.examples.quickstart \
                       --device cpu
"""
import argparse

from repro_torch.configs import get_arch
from repro_torch.core.explorer import min_capacity_mib, sweep
from repro_torch.core.workload import build_graph
from repro_torch.device import require_device
from repro_torch.sim.accelerator import baseline_accelerator
from repro_torch.sim.engine import simulate

MIB = 2**20


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    device = require_device(ap.parse_args().device)
    for name, cap in (("dsr1d-qwen-1.5b", 128), ("gpt2-xl", 160)):
        cfg = get_arch(name)
        graph = build_graph(cfg, M=2048, subops=4)
        print(f"\n=== {name}: {graph.total_macs()/1e12:.2f} TMACs, "
              f"{len(graph.ops)} ops ===")

        # Stage I
        sim = simulate(graph, baseline_accelerator(cap))
        trace = sim.traces["sram"]
        print(f"simulated {sim.total_time*1e3:.1f} ms | "
              f"peak needed {trace.peak_needed()/MIB:.1f} MiB | "
              f"PE util {sim.pe_utilization*100:.1f}% | "
              f"capacity write-backs: {sim.writebacks}")

        # Stage II
        lo = min_capacity_mib(trace.peak_needed())
        table = sweep(sim, capacities_mib=[lo, 128], device=device)
        print(table.format())
        best = table.best()
        print(f"--> recommended: C={best.capacity_mib} MiB, B={best.banks} "
              f"banks ({best.delta_e_pct:+.1f}% energy, "
              f"{best.delta_a_pct:+.1f}% area vs monolithic)")


if __name__ == "__main__":
    main()
