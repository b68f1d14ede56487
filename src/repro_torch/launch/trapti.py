"""TRAPTI co-design CLI — the paper's two-stage flow as a framework command;
the port of the reference's `repro/launch/trapti.py`, with the same flags
and `--json` payload. Stage I (the host simulator) is the reference's;
Stage II runs on `--device`: the CUDA bank-energy kernels on the card
(default), their plain float64 versions with `--device cpu`.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.trapti --arch dsr1d-qwen-1.5b
    PYTHONPATH=src python -m repro_torch.launch.trapti --arch qwen2-7b \
        --seq 4096 --scheduler mempeak --policy drowsy --json out.json
    PYTHONPATH=src python -m repro_torch.launch.trapti --device cpu \
        --fidelity pss --decode-steps 1024 --decode-batch 16
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_arch, list_archs
from repro_torch.core.candidates import Candidate, evaluate_candidates
from repro_torch.core.energy import assemble_energy
from repro_torch.core.explorer import min_capacity_mib, sweep
from repro_torch.core.sensitivity import policy_sensitivity
from repro_torch.core.workload import build_decode_graph, build_graph
from repro_torch.device import require_device
from repro_torch.sim.accelerator import baseline_accelerator, multilevel_accelerator
from repro_torch.sim.engine import find_min_sram, simulate
from repro_torch.sim.pss import simulate_decode

MIB = 2**20


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="dsr1d-qwen-1.5b",
                    help=f"one of {list_archs()}")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--phase", choices=["prefill", "decode"],
                    default="prefill")
    ap.add_argument("--decode-batch", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=0,
                    help="simulate a decode *horizon* of this many steps "
                         "(0 = single decode step / prefill as before)")
    ap.add_argument("--fidelity", choices=["exact", "pss", "auto"],
                    default="exact",
                    help="Stage-I decode-horizon engine: pss/auto probe a "
                         "few context lengths and tile the periodic steady "
                         "state; exact runs the DES per step. pss/auto "
                         "imply --phase decode")
    ap.add_argument("--memoize-layers", action="store_true",
                    help="replay structurally identical decoder layers "
                         "inside the DES (timestamps exact to float "
                         "translation error)")
    ap.add_argument("--scheduler", choices=["fifo", "mempeak"],
                    default="fifo")
    ap.add_argument("--policy", choices=["conservative", "aggressive",
                                         "drowsy"], default="conservative")
    ap.add_argument("--multilevel", action="store_true")
    ap.add_argument("--banks", type=int, nargs="+",
                    default=[1, 2, 4, 8, 16, 32])
    ap.add_argument("--sensitivity", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="Stage-II device: the CUDA kernels on the card, "
                         "or their plain versions on the CPU")
    ap.add_argument("--prune", action="store_true",
                    help="lower-bound prune before exact grid evaluation")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    device = require_device(args.device)
    cfg = get_arch(args.arch)
    if args.fidelity != "exact" and args.phase != "decode":
        print(f"--fidelity {args.fidelity} targets the decode phase; "
              f"switching --phase decode")
        args.phase = "decode"
    if args.fidelity != "exact" and args.decode_steps <= 0:
        args.decode_steps = 64

    # ---- Stage I: size the SRAM, extract the trace --------------------------
    accel = (multilevel_accelerator(64) if args.multilevel
             else baseline_accelerator(128))
    if args.phase == "decode" and args.decode_steps > 0:
        # decode horizon: PSS probe-and-tile (or exact per-step) Stage I
        sim = simulate_decode(
            cfg, accel, start_ctx=args.seq, steps=args.decode_steps,
            batch=args.decode_batch, fidelity=args.fidelity,
            policy=args.scheduler, memoize_layers=args.memoize_layers)
        mib = next(m.capacity for m in accel.memories
                   if m.name == "sram") // MIB
        energy = assemble_energy(sim, accel)
        n_ev = sum(t.n_events for t in sim.traces.values())
        print(f"workload: {sim.graph_name}  "
              f"{sim.total_macs/1e12:.2f} TMACs over {sim.steps} steps")
        print(f"Stage I [fidelity={sim.fidelity}]: "
              f"t={sim.total_time*1e3:.1f} ms  "
              f"probes={len(sim.probes)}/{sim.steps} steps  "
              f"events={n_ev}  E_onchip={energy.total:.1f} J  "
              f"write-backs={sim.writebacks}"
              + (f"  [fallback: {sim.fallback_reason}]"
                 if sim.fallback_reason else ""))
    else:
        if args.phase == "decode":
            graph = build_decode_graph(cfg, context_len=args.seq,
                                       batch=args.decode_batch)
        else:
            graph = build_graph(cfg, M=args.seq, subops=4)
        print(f"workload: {graph.name}  {graph.total_macs()/1e12:.2f} "
              f"TMACs, {len(graph.ops)} ops, weights "
              f"{graph.total_weight_bytes()/MIB:.0f} MiB")
        if args.multilevel:
            sim = simulate(graph, accel, policy=args.scheduler,
                           memoize_layers=args.memoize_layers)
            mib = 64
        else:
            mib, sim = find_min_sram(graph, accel, lo_mib=16, hi_mib=256,
                                     step_mib=16)
            if args.scheduler != "fifo" or args.memoize_layers:
                sim = simulate(graph, accel.with_sram_capacity(mib * MIB),
                               policy=args.scheduler,
                               memoize_layers=args.memoize_layers)
        energy = assemble_energy(sim, accel)
        print(f"Stage I [{args.scheduler}]: t={sim.total_time*1e3:.1f} ms  "
              f"util={sim.pe_utilization*100:.1f}%  "
              f"E_onchip={energy.total:.1f} J  min SRAM={mib} MiB  "
              f"write-backs={sim.writebacks}")

    # horizon mode runs at the accelerator's fixed SRAM (no bisection), so
    # min_sram_mib would be misleading there; report the capacity instead
    horizon = args.phase == "decode" and args.decode_steps > 0
    report = {"arch": args.arch, "seq": args.seq, "phase": args.phase,
              "scheduler": args.scheduler, "fidelity": args.fidelity,
              "decode_steps": args.decode_steps,
              "min_sram_mib": None if horizon else mib,
              "sram_capacity_mib": mib,
              "time_ms": sim.total_time * 1e3,
              "energy_onchip_j": energy.total, "memories": {}}

    # ---- Stage II: banking + gating per on-chip memory ----------------------
    for mem in sim.traces:
        if mem == "dram":
            continue
        trace = sim.traces[mem]
        if trace.peak_needed() == 0:
            continue
        lo = min_capacity_mib(trace.peak_needed())
        table = sweep(sim, mem_name=mem, capacities_mib=[lo],
                      banks=tuple(args.banks), device=device,
                      prune=args.prune)
        best = table.best()
        print(f"\nStage II [{mem}] peak={trace.peak_needed()/MIB:.1f} MiB:")
        print(table.format())
        line = (f"--> {mem}: C={best.capacity_mib} MiB, B={best.banks} "
                f"({best.delta_e_pct:+.1f}% E, {best.delta_a_pct:+.1f}% A)")
        if args.policy == "drowsy":
            dur, occ = trace.occupancy_series(sim.total_time, use="needed")
            res = evaluate_candidates(
                dur, occ, [Candidate(best.capacity_mib * MIB, best.banks,
                                     policy="drowsy")],
                n_reads=sim.access.n_reads(mem),
                n_writes=sim.access.n_writes(mem), device=device)
            dr = res.drowsy_result(0)
            gain = (1 - dr.e_total / best.result.e_total) * 100
            line += (f"  drowsy: {dr.e_total*1e3:.1f} mJ "
                     f"({gain:+.1f}% vs off-only)")
        print(line)
        report["memories"][mem] = {
            "peak_mib": trace.peak_needed() / MIB,
            "best_capacity_mib": best.capacity_mib,
            "best_banks": best.banks,
            "best_delta_e_pct": best.delta_e_pct,
        }

        if args.sensitivity and mem == "sram":
            dur, occ = trace.occupancy_series(sim.total_time, use="needed")
            sens = policy_sensitivity(
                dur, occ, capacity=best.capacity_mib * MIB,
                banks=best.banks, n_reads=sim.access.n_reads(mem),
                n_writes=sim.access.n_writes(mem), device=device)
            print("    sensitivity (E_tot mJ):")
            for k, row in sens.items():
                vals = " ".join(f"{p}:{v*1e3:.1f}" for p, v in row.items())
                print(f"      {k:10s} {vals}")
            report["sensitivity"] = {
                k: {str(p): v for p, v in row.items()}
                for k, row in sens.items()}

    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"\nwrote {args.json}")


if __name__ == "__main__":
    main()
