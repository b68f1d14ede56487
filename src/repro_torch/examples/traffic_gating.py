"""Serving traffic -> occupancy trace -> online power gating, end to end, on
the port. Counterpart of the reference's `examples/traffic_gating.py`.

The paper's Stage I traces ONE inference; here the workload is a stream of
requests (Poisson arrivals, lognormal lengths) served by a continuous
batcher, so KV occupancy fluctuates with load, the regime where the online
power-gating controller earns its keep:

  1. generate one seeded request stream;
  2. replay it through the model-free multi-tenant occupancy model for the
     paper's MHA (GPT-2 XL) and GQA (DeepSeek-R1-Distill-Qwen-1.5B)
     workloads;
  3. compare no-gating vs offline-oracle vs online-controller energy on each
     trace, plus the wake-up latency the online policy exposes (the offline
     legs run the `exact_bank_stats` kernel on `--device`);
  4. feed the same traffic trace to the unmodified Stage-II sweep().

Run on the card:   PYTHONPATH=src python -m repro_torch.examples.traffic_gating
Run on the CPU:    PYTHONPATH=src python -m \
                       repro_torch.examples.traffic_gating --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_arch
from repro_torch.core.explorer import min_capacity_mib, sweep
from repro_torch.device import require_device
from repro_torch.traffic import (LengthModel, compare, generate,
                                 simulate_traffic, utilization_summary)

MIB = 2**20


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    device = require_device(args.device)

    # one stream, both architectures: identical traffic, directly comparable
    reqs = generate("poisson", 4.0, 20.0, seed=0,
                    lengths=LengthModel(max_len=1024))
    print(f"traffic: {len(reqs)} requests over 20 s (poisson @ 4/s, seed 0)")

    for name in ("gpt2-xl", "dsr1d-qwen-1.5b"):
        cfg = get_arch(name)
        sim = simulate_traffic(cfg, reqs, num_slots=8, max_len=1024)
        u = utilization_summary(sim)
        print(f"\n=== {name} ===")
        print(f"peak {u['peak_bytes']/MIB:.1f} MiB | "
              f"mean {u['mean_bytes']/MIB:.1f} MiB | "
              f"p95 latency {u['p95_latency_s']:.2f} s | "
              f"{sim.stats.finished} finished")

        # right-size the pool memory from the traffic peak, then gate it
        cap = min_capacity_mib(sim.trace.peak_needed()) * MIB
        dur, occ = sim.trace.occupancy_series(sim.total_time, use="needed")
        c = compare(dur, occ, capacity=cap, banks=8,
                    n_reads=sim.bundle.access.n_reads("kv"),
                    n_writes=sim.bundle.access.n_writes("kv"), device=device)
        print(f"C={cap//MIB} MiB, B=8: {c.format()}")

        # Stage II consumes the traffic trace exactly like a Stage-I trace
        table = sweep(sim.bundle, mem_name="kv",
                      capacities_mib=[cap // MIB], banks=(1, 4, 8, 16),
                      device=device)
        print(table.format())


if __name__ == "__main__":
    main()
