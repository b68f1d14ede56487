"""Serving-traffic campaign CLI — traffic as a first-class TRAPTI workload;
the port of the reference's `repro/launch/traffic.py`, with the same flags
and `--json` payload, except that `--device {cuda,cpu}` replaces
`--fast-backend` and `--backend`: the campaign's Stage-II legs (the
lower-bound grid, the offline oracle and no-gating legs, the banking sweep)
run the CUDA bank-energy kernels on the card by default, their plain
float64 versions with `--device cpu`.

Sweeps traffic intensity x model x (C, B) and reports online-controller vs
offline-oracle vs no-gating energy under *identical* request streams, plus a
Stage-II banking sweep run directly on the traffic-generated trace. The MHA
reference (gpt2-xl) is always included next to the requested models, so every
report carries the paper's MHA-vs-GQA comparison under load.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.traffic \
        --model dsr1d_qwen_1_5b --arrival poisson --rate 4 --seed 0
    PYTHONPATH=src python -m repro_torch.launch.traffic \
        --arrival bursty --rate 2 8 --horizon 20 --json out.json
    PYTHONPATH=src python -m repro_torch.launch.traffic --device cpu \
        --horizon 5 --slots 4 --max-len 512 --banks 1 8
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import resolve_arch
from repro_torch.core.explorer import MIB, min_capacity_mib, sweep
from repro_torch.device import require_device
from repro_torch.traffic.campaign import (DEFAULT_BANKS, CampaignReport,
                                          run_campaign)
from repro_torch.traffic.controller import ControllerConfig, ForecastConfig
from repro_torch.traffic.generators import LengthModel

MHA_REFERENCE = "gpt2-xl"

KV_DTYPES = ["fp32", "bf16", "fp16", "int8", "fp8"]


def build_report_dict(report: CampaignReport) -> dict:
    rows = []
    for r in report.rows:
        c = r.comparison
        row = {
            "arch": r.scenario.arch, "arrival": r.scenario.arrival,
            "rate": r.scenario.rate, "seed": r.scenario.seed,
            "kv_dtype": r.scenario.kv_dtype,
            "capacity_mib": r.capacity_mib, "banks": r.banks,
            "peak_mib": r.peak_mib, "mean_mib": r.mean_mib,
            "e_none_j": c.none.e_total, "e_oracle_j": c.oracle.e_total,
            "e_online_j": c.online.e_total,
            "online_vs_none_pct": c.online_vs_none_pct,
            "online_vs_oracle_pct": c.online_vs_oracle_pct,
            "wake_violations": c.online.wake_violations,
            "stall_s": c.online.stall_s,
            "p95_latency_s": r.p95_latency_s,
        }
        if r.scenario.speculate_k is not None:
            row.update({
                "speculate_k": r.scenario.speculate_k,
                "spec_acceptance": r.scenario.spec_acceptance,
                "draft_kv_frac": r.scenario.draft_kv_frac,
            })
        if c.forecast is not None:
            row.update({
                "e_forecast_j": c.forecast.e_total,
                "forecast_vs_oracle_pct": c.forecast_vs_oracle_pct,
                "forecast_wake_violations": c.forecast.wake_violations,
                "forecast_stall_s": c.forecast.stall_s,
                "forecast_pre_wakes": c.forecast.pre_wakes,
                "forecast_early_wake_s": c.forecast.early_wake_s,
            })
        if r.energy is not None:
            e = r.energy
            row["energy"] = {
                "meter_capacity_mib": e.result.capacity / MIB,
                "meter_banks": e.result.banks,
                "meter_alpha": e.result.alpha,
                "meter_policy": e.result.policy,
                "e_total_j": e.result.e_total,
                "e_leak_j": e.result.e_leak,
                "e_sw_j": e.result.e_sw,
                "live_e_j": e.live_e_j,
                "floor_j": e.floor_j,
                "stall_s": e.stall_s,
                "wakes": dict(e.wakes),
                "j_per_request_p50_p90_p99": list(e.j_per_request),
                "tenant_j": {str(k): v for k, v in e.tenant_j.items()},
            }
        rows.append(row)
    return {"rows": rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", nargs="+", default=["dsr1d-qwen-1.5b"],
                    help="arch name(s); '_' spellings accepted "
                         "(dsr1d_qwen_1_5b == dsr1d-qwen-1.5b)")
    ap.add_argument("--arrival", nargs="+", default=["poisson"],
                    choices=["poisson", "bursty", "diurnal"])
    ap.add_argument("--workload", default="plain",
                    choices=["plain", "chat_sysprompt", "fewshot",
                             "agentic_fanout"],
                    help="shared-prefix workload family; non-plain runs the "
                         "page-granular prefix-sharing simulator and sweeps "
                         "the grid against PHYSICAL occupancy")
    ap.add_argument("--prefix-len", type=int, default=512,
                    help="mean shared-prefix length [tokens]")
    ap.add_argument("--sharing", type=int, default=8,
                    help="sharing factor (expected requests per prefix; "
                         "fan-out width for agentic_fanout)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size [tokens] for shared workloads")
    ap.add_argument("--speculate", type=int, default=None, metavar="K",
                    help="draft K tokens per round through the model-free "
                         "speculative-decoding simulator (page-granular "
                         "burst/rollback occupancy, both KV lanes); "
                         "plain workload only")
    ap.add_argument("--spec-acceptance", type=float, default=0.7,
                    help="per-draft-token acceptance probability for "
                         "--speculate")
    ap.add_argument("--draft", "--draft-kv-frac", dest="draft_kv_frac",
                    type=float, default=0.5,
                    help="draft lane cost as a fraction of the target "
                         "(KV bytes per page and compute per step; 0.5 = "
                         "half-depth self-speculation)")
    ap.add_argument("--kv-dtype", nargs="+", default=["bf16"],
                    choices=KV_DTYPES,
                    help="KV-cache dtype(s); more than one runs the "
                         "campaign once per dtype on identical request "
                         "streams and prints the quantized-KV "
                         "energy frontier")
    ap.add_argument("--rate", nargs="+", type=float, default=[4.0],
                    help="mean request rate(s) [req/s]")
    ap.add_argument("--seed", nargs="+", type=int, default=[0])
    ap.add_argument("--horizon", type=float, default=30.0)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--capacity", nargs="+", type=int, default=None,
                    help="capacities [MiB]; default: derived from each "
                         "trace's peak")
    ap.add_argument("--banks", nargs="+", type=int,
                    default=list(DEFAULT_BANKS))
    ap.add_argument("--alpha", type=float, default=0.9)
    ap.add_argument("--hysteresis", type=float, default=2.0,
                    help="online gate-off threshold, x break-even time")
    ap.add_argument("--controller", default="reactive",
                    choices=["reactive", "forecast"],
                    help="'forecast' adds the PSS-forecast pre-wake "
                         "controller as a fourth leg next to "
                         "reactive/oracle/none")
    ap.add_argument("--forecast-window", type=float, default=2.0,
                    help="trailing affine-fit window [s] for the forecast "
                         "controller")
    ap.add_argument("--forecast-lead", type=float, default=None,
                    help="pre-wake lead horizon [s]; default window/20")
    ap.add_argument("--resample-dt", type=float, default=None,
                    help="coarsen traces to this grid [s] before evaluation")
    ap.add_argument("--no-mha-ref", action="store_true",
                    help="skip the always-on gpt2-xl MHA reference")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="Stage-II device (lower-bound grid, oracle/none "
                         "legs, banking sweep): the CUDA kernels on the "
                         "card, or their plain float64 versions on the CPU")
    ap.add_argument("--prune", action="store_true",
                    help="prune the (C, B) grid with the lower bound "
                         "before exact evaluation")
    ap.add_argument("--fidelity", default="auto",
                    choices=["exact", "pss", "auto"],
                    help="traffic-simulator fast path: pss/auto fast-forward "
                         "uneventful lockstep stretches (bit-identical); "
                         "exact steps every iteration")
    ap.add_argument("--meter", default=None, metavar="C,B[,alpha[,policy]]",
                    help="stream a BankEnergyMeter over every scenario's "
                         "trace (C in MiB); adds per-request/per-tenant "
                         "energy attribution and wake-cause counters to "
                         "the report and --json rows")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    device = require_device(args.device)

    try:
        archs = [resolve_arch(m).name for m in args.model]
    except KeyError as e:
        ap.error(str(e))
    if not args.no_mha_ref and MHA_REFERENCE not in archs:
        archs = [MHA_REFERENCE] + archs
    # dedupe, keep order
    archs = list(dict.fromkeys(archs))

    kv_dtypes = list(dict.fromkeys(args.kv_dtype))
    print(f"traffic campaign: models={archs} arrivals={args.arrival} "
          f"rates={args.rate} seeds={args.seed} horizon={args.horizon}s "
          f"slots={args.slots} max_len={args.max_len} "
          f"kv_dtype={kv_dtypes}")

    fcfg = (ForecastConfig(window_s=args.forecast_window,
                           lead_s=args.forecast_lead)
            if args.controller == "forecast" else None)
    reports = {}
    for dt in kv_dtypes:
        reports[dt] = run_campaign(
            archs, arrivals=args.arrival, rates=args.rate, seeds=args.seed,
            horizon_s=args.horizon, num_slots=args.slots,
            max_len=args.max_len,
            capacities_mib=args.capacity, banks=args.banks,
            ctrl=ControllerConfig(alpha=args.alpha,
                                  hysteresis_multiple=args.hysteresis),
            fcfg=fcfg,
            lengths=LengthModel(max_len=args.max_len),
            resample_dt=args.resample_dt, device=device,
            prune=args.prune, fidelity=args.fidelity,
            workload=args.workload, prefix_len=args.prefix_len,
            sharing=args.sharing, page_size=args.page_size, kv_dtype=dt,
            speculate_k=args.speculate, spec_acceptance=args.spec_acceptance,
            draft_kv_frac=args.draft_kv_frac, meter_spec=args.meter)
    report = reports[kv_dtypes[0]]

    if args.workload != "plain":
        print(f"\n# prefix sharing ({args.workload}, sharing={args.sharing}, "
              f"prefix~{args.prefix_len} tok): logical vs physical occupancy")
        for (arch, tkey), sim in sorted(report.sims.items()):
            tr = sim.bundle.traces["kv"]
            lg = sim.bundle.traces["kv_logical"]
            st = sim.stats
            phys, logi = tr.peak_needed(), lg.peak_needed()
            print(f"  {arch:>20} {tkey[0]}@{tkey[1]:g}/s seed={tkey[2]}: "
                  f"peak {logi / MIB:.1f} -> {phys / MIB:.1f} MiB "
                  f"({logi / max(phys, 1):.2f}x), hits "
                  f"{st.prefix_hits}/{st.admitted}, "
                  f"{st.prefix_tokens_reused} tok reused, "
                  f"{st.cow_splits} COW, {st.evicted_pages} pages evicted")

    if args.speculate is not None:
        print(f"\n# speculative decoding (k={args.speculate}, "
              f"acceptance={args.spec_acceptance:g}, "
              f"draft={args.draft_kv_frac:g}x): burst/rollback occupancy")
        for (arch, tkey), sim in sorted(report.sims.items()):
            st = sim.stats
            V = args.speculate + 1
            toks_per_round = (st.accepted_tokens / st.spec_rounds
                              if st.spec_rounds else 0.0)
            print(f"  {arch:>20} {tkey[0]}@{tkey[1]:g}/s seed={tkey[2]}: "
                  f"{st.spec_rounds} rounds, "
                  f"{toks_per_round:.2f}/{V} tok/round accepted "
                  f"(rate {st.acceptance_rate:.2f}), "
                  f"{st.rolled_back_pages} pages rolled back, "
                  f"peak {sim.trace.peak_needed() / MIB:.1f} MiB")

    legs = ("online reactive+forecast controllers"
            if fcfg is not None else "online controller")
    print(f"\n# {legs} vs offline oracle vs no gating")
    print(report.format())
    if not report.rows:
        print("  (no rows: every requested --capacity sits below the traffic "
              "peak; drop --capacity to derive it from the trace)")

    print("\n# best (C, B) per scenario by online energy")
    for r in sorted(report.best_per_scenario(),
                    key=lambda r: (r.scenario.traffic_key, r.scenario.arch)):
        c = r.comparison
        print(f"  {r.scenario.arch:>20} {r.scenario.arrival}@"
              f"{r.scenario.rate:g}/s seed={r.scenario.seed}: "
              f"C={r.capacity_mib} MiB B={r.banks}  peak={r.peak_mib:.1f} MiB  "
              f"{c.format()}")

    # ---- MHA vs GQA headline under identical traffic ------------------------
    # group best rows by traffic key so each comparison really uses the same
    # request stream for both architectures
    by_traffic = {}
    for r in report.best_per_scenario():
        by_traffic.setdefault(r.scenario.traffic_key, {})[r.scenario.arch] = r
    for tkey, by_arch in sorted(by_traffic.items()):
        ref = by_arch.get(MHA_REFERENCE)
        if ref is None or len(by_arch) < 2:
            continue
        for a, r in sorted(by_arch.items()):
            if a == MHA_REFERENCE:
                continue
            print(f"\n# {a} vs {MHA_REFERENCE} under identical traffic "
                  f"({tkey[0]}@{tkey[1]:g}/s seed={tkey[2]}): "
                  f"peak {ref.peak_mib / max(r.peak_mib, 1e-9):.2f}x lower, "
                  f"online energy {ref.e_online / max(r.e_online, 1e-12):.2f}x"
                  f" lower")

    # ---- Stage II runs unmodified on the traffic trace ----------------------
    print("\n# Stage-II sweep() on the traffic-generated trace")
    for (arch, tkey), sim in report.sims.items():
        if arch != archs[-1]:
            continue
        table = sweep(sim.bundle, mem_name="kv",
                      max_capacity_mib=max(
                          128, int(sim.trace.peak_needed() / MIB) + 16),
                      device=device)
        print(table.format())
        break

    # ---- quantized-KV energy frontier ---------------------------------------
    # every dtype leg saw the identical request stream; Stage II is swept at
    # the capacity the WIDEST dtype's trace needs, so shrinking bytes shows
    # up as gating headroom (dB1% = banked+gated energy vs monolithic B=1)
    # rather than as a smaller memory
    if len(reports) > 1:
        wide = max(kv_dtypes,
                   key=lambda d: reports[d].rows[0].scenario.kv_dtype_bytes
                   if reports[d].rows else 0)
        print(f"\n# quantized-KV energy frontier (Stage-II at the "
              f"{wide}-trace capacity)")
        for (arch, tkey), wide_sim in sorted(reports[wide].sims.items()):
            cap_mib = max(min_capacity_mib(wide_sim.trace.peak_needed()), 16)
            print(f"  {arch} {tkey[0]}@{tkey[1]:g}/s seed={tkey[2]} "
                  f"(C={cap_mib} MiB):")
            print(f"    {'kv_dtype':>8} {'B/el':>4} {'peak[MiB]':>9} "
                  f"{'E_online[mJ]':>12} {'dNone%':>7} {'E_bank[mJ]':>10} "
                  f"{'dB1%':>7}")
            for dt in kv_dtypes:
                rep = reports[dt]
                best = {(r.scenario.arch, r.scenario.traffic_key): r
                        for r in rep.best_per_scenario()}.get((arch, tkey))
                sim = rep.sims.get((arch, tkey))
                if best is None or sim is None:
                    continue
                brow = sweep(sim.bundle, mem_name="kv",
                             capacities_mib=[cap_mib], device=device).best()
                print(f"    {dt:>8} {best.scenario.kv_dtype_bytes:>4} "
                      f"{best.peak_mib:>9.1f} {best.e_online * 1e3:>12.2f} "
                      f"{best.comparison.online_vs_none_pct:>+7.1f} "
                      f"{brow.result.e_total * 1e3:>10.2f} "
                      f"{brow.delta_e_pct:>+7.1f}")

    if args.json:
        payload = build_report_dict(report) if len(reports) == 1 else {
            "rows": [row for dt in kv_dtypes
                     for row in build_report_dict(reports[dt])["rows"]]}
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"\nwrote {args.json}")


if __name__ == "__main__":
    main()
