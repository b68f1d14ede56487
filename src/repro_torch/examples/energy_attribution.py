"""Energy-attribution walkthrough on the port: mixed-tenant prefix traffic
-> streaming per-bank energy meter -> J/request percentiles + per-tenant
split -> exact check against offline Stage II -> Perfetto bank-state
timeline on disk. Counterpart of the reference's
`examples/energy_attribution.py`.

  1. a `chat_sysprompt` workload (tenant groups share system prompts) is
     drawn from the seeded traffic generators and replayed through the
     model-free prefix-sharing simulator with a `BankEnergyMeter`
     attached: every page alloc/free/COW event updates an online per-bank
     active/drowsy/gated state machine for one (C, B, alpha, policy)
     operating point, charging each bank-wake transient and retention
     interval to the request (and tenant) that caused or sustained it;
  2. `meter.report()` renders live leakage+switching energy, J/request
     p50/p90/p99, the per-tenant energy split, wake-cause counters and
     gating stall exposure;
  3. the cumulative integral is checked bit for bit (f64) against
     `core.gating.evaluate` over the very occupancy trace the sim emitted,
     and against the batched Stage-II engine on `--device` (the
     `exact_bank_stats` kernel on the card) within rel 1e-12;
  4. `export_chrome_trace(meter=...)` writes per-bank state lanes plus
     cumulative-energy and active-bank counter tracks next to the KV
     occupancy track, loadable at https://ui.perfetto.dev.

Run on the card:   PYTHONPATH=src python -m \
                       repro_torch.examples.energy_attribution
Run on the CPU:    PYTHONPATH=src python -m \
                       repro_torch.examples.energy_attribution --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.core.candidates import Candidate, evaluate_candidates
from repro_torch.core.gating import evaluate
from repro_torch.device import require_device
from repro_torch.obs import BankEnergyMeter, export_chrome_trace
from repro_torch.traffic import (LengthModel, generate_workload,
                                 simulate_prefix_traffic)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dsr1d-qwen-1.5b")
    ap.add_argument("--meter", default="32,8,0.9,conservative",
                    metavar="C,B[,alpha[,policy]]",
                    help="capacity [MiB], banks, target occupancy, policy")
    ap.add_argument("--rate", type=float, default=6.0)
    ap.add_argument("--horizon", type=float, default=8.0)
    ap.add_argument("--sharing", type=int, default=4)
    ap.add_argument("--prefix-len", type=int, default=128)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="energy_timeline.json")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    device = require_device(args.device)

    cfg = get_arch(args.arch)

    # ---- mixed-tenant workload + metered model-free serve ---------------
    lengths = LengthModel(max_len=args.max_len)
    reqs = generate_workload("chat_sysprompt", rate=args.rate,
                             horizon_s=args.horizon, seed=args.seed,
                             lengths=lengths, prefix_len=args.prefix_len,
                             sharing=args.sharing)
    meter = BankEnergyMeter.from_spec(args.meter)
    sim = simulate_prefix_traffic(cfg, reqs, num_slots=4,
                                  max_len=args.max_len, seed=args.seed,
                                  meter=meter)
    n_tenants = len({r.prefix_id for r in reqs})
    print(f"{args.arch}: {sim.stats.finished}/{len(reqs)} requests from "
          f"{n_tenants} tenants, {sim.stats.prefix_hits} prefix hits, "
          f"{meter.n_events} meter events")

    # ---- streaming report: J/request, per-tenant split, wake causes -----
    tokens_by_rid = {r.rid: r.prompt_len + r.output_len for r in reqs}
    rep = meter.report(sim.total_time, tokens_by_rid=tokens_by_rid)
    print()
    print(rep.format())

    # ---- exactness: streamed integral == offline Stage II (f64) ---------
    dur, occ = sim.trace.occupancy_series(sim.total_time, use="needed")
    ref = evaluate(dur, occ, capacity=meter.capacity, banks=meter.banks,
                   policy=meter.policy, n_reads=0, n_writes=0,
                   char=meter.char)
    got = rep.result
    assert (got.e_leak, got.e_sw, got.n_transitions) == \
        (ref.e_leak, ref.e_sw, ref.n_transitions), "meter drifted offline!"
    print(f"\nexact vs offline gating.evaluate: MATCH (bit-identical f64) — "
          f"E_leak+E_sw = {(got.e_leak + got.e_sw) * 1e3:.4f} mJ over "
          f"{got.n_transitions} bank transitions")
    pol = meter.policy
    eng = evaluate_candidates(
        dur, occ, [Candidate(meter.capacity, meter.banks, pol.alpha, "gate",
                             pol.min_gate_multiple)],
        n_reads=0, n_writes=0, device=device)
    rel = abs(float(eng.e_total[0]) - got.e_total) / got.e_total
    assert rel <= 1e-12 and int(eng.n_off[0]) == got.n_transitions, rel
    print(f"batched engine on {device}: E_total rel diff {rel:.1e}")

    # conservation: every joule lands on a request, a tenant, or the floor
    req_j = sum(rep.request_j.values())
    ten_j = sum(rep.tenant_j.values())
    assert np.isclose(req_j + rep.floor_j, rep.live_e_j, rtol=1e-9)
    assert np.isclose(ten_j + rep.floor_j, rep.live_e_j, rtol=1e-9)
    print(f"attribution conserves energy: {req_j * 1e3:.4f} mJ on requests "
          f"+ {rep.floor_j * 1e3:.4f} mJ idle floor = total")

    # ---- Perfetto bank-state timeline -----------------------------------
    export_chrome_trace(args.out, traces=sim.bundle.traces.values(),
                        end_time=sim.total_time, meter=meter)
    print(f"\nwrote {args.out} ({meter.banks} bank-state lanes + energy "
          f"counters) — load it at ui.perfetto.dev: bank lanes under "
          f"'sram banks', cumulative J + active banks as counter tracks")


if __name__ == "__main__":
    main()
