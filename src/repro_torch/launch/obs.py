"""Observability CLI: run a small paged serve, report metrics or export a
Perfetto timeline; the port of the reference's `repro/launch/obs.py`, with
its flags and defaults plus `--device {cuda,cpu}` (the serve's model, and so
its prefill and paged-decode kernels, run on the card by default).

Drives `PagedContinuousBatcher` with an enabled `Telemetry` registry over a
seeded shared-prefix workload, then either prints the registry + SLO
percentiles (`report`) or writes a Chrome-trace-event JSON (`export`) that
ui.perfetto.dev / chrome://tracing load directly — request lifecycle spans,
per-slot prefill lanes, decode chunks and the KV-occupancy counter track
all on the batcher's one logical timeline.

The `energy` subcommand streams a `BankEnergyMeter` over the same event
stream: per-request/per-tenant energy attribution, wake-cause counters and
the exact Stage-II integral (bit-identical to the offline evaluation), as a
one-shot report, a `--watch` live dashboard, or a Perfetto export with
bank-state timeline lanes and energy counter tracks (`--out`).

The serve's weights are random, drawn from a `torch.Generator` seeded 0
(the reference draws JAX's; the scheduling, spans, SLOs and energy depend
only on token counts, not on the tokens).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.obs report \
        --arch dsr1d_qwen_1_5b
    PYTHONPATH=src python -m repro_torch.launch.obs export \
        --arch dsr1d_qwen_1_5b --requests 4 --new-tokens 8 --slots 2 \
        --out obs_trace.json
    PYTHONPATH=src python -m repro_torch.launch.obs energy \
        --meter 32,8,0.9,conservative --rate 6 --horizon 8 --watch
    PYTHONPATH=src python -m repro_torch.launch.obs report --device cpu
"""
from __future__ import annotations

import argparse
from dataclasses import asdict

import numpy as np
import torch

from repro_torch.configs import reduced, resolve_arch
from repro_torch.device import require_device
from repro_torch.models import DecoderLM
from repro_torch.obs import Telemetry, export_chrome_trace
from repro_torch.params import init_params
from repro_torch.serve import PagedContinuousBatcher, Request
from repro_torch.traffic.generators import (LengthModel, generate_workload,
                                      materialize_tokens)


def run_serve(args, meter=None) -> tuple:
    """One telemetry-enabled paged serve; returns (tel, batcher, done)."""
    cfg = reduced(resolve_arch(args.arch), layers=args.layers)
    model = DecoderLM(cfg, compute_dtype=torch.float32, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(0)
    params = init_params(cfg, gen, device=model.device)

    lengths = LengthModel(prompt_mean=16.0, prompt_sigma=0.4,
                          output_mean=args.new_tokens, max_len=96)
    specs = generate_workload("chat_sysprompt", rate=4.0,
                              horizon_s=float(args.requests), seed=args.seed,
                              lengths=lengths, prefix_len=args.prefix_len,
                              sharing=args.sharing)[:args.requests]
    tokens = materialize_tokens(specs, cfg.vocab_size, seed=args.seed)

    tel = Telemetry(enabled=True)        # spans on; clock -> batcher sim time
    cb = PagedContinuousBatcher(
        model, params, num_slots=args.slots, page_size=args.page_size,
        num_pages=args.num_pages, chunk_steps=args.chunk_steps,
        prefix_cache=args.prefix, telemetry=tel,
        meter=meter)
    for s, toks in zip(specs, tokens):
        tenant = None if s.prefix_id is None else f"tenant{s.prefix_id}"
        cb.submit(Request(rid=s.rid, tokens=np.asarray(toks),
                          max_new_tokens=max(s.output_len, 2),
                          tenant=tenant))
    done = cb.run()
    return tel, cb, done


def run_energy(args) -> None:
    """The `energy` subcommand: stream a meter over a serve or a model-free
    sim, then report attribution (and optionally watch/export)."""
    from repro_torch.core.gating import evaluate
    from repro_torch.obs.energy import BankEnergyMeter

    meter = BankEnergyMeter.from_spec(args.meter)
    if args.watch:
        interval = max(float(args.interval), 1e-6)
        orig_record = meter.record
        state = {"next": interval}

        def record(t, *a, **kw):
            orig_record(t, *a, **kw)
            if t >= state["next"]:
                print(meter.format_dashboard(float(t)))
                state["next"] = float(t) + interval
        meter.record = record

    if args.serve:
        tel, cb, done = run_serve(args, meter=meter)
        summary = cb.slo_summary()
        end = cb.occupancy_bundle().total_time
        source_trace = cb.ledger.trace
        n_served = len(done)
    else:
        from repro_torch.traffic.generators import generate, generate_workload
        from repro_torch.traffic.occupancy import (simulate_prefix_traffic,
                                             simulate_traffic)
        cfg = resolve_arch(args.arch)
        lengths = LengthModel(max_len=args.max_len)
        if args.workload == "plain":
            reqs = generate("poisson", args.rate, args.horizon,
                            seed=args.seed, lengths=lengths)
            sim = simulate_traffic(cfg, reqs, num_slots=args.slots,
                                   max_len=args.max_len, meter=meter)
        else:
            reqs = generate_workload(args.workload, args.rate, args.horizon,
                                     seed=args.seed, lengths=lengths,
                                     prefix_len=args.prefix_len,
                                     sharing=args.sharing)
            sim = simulate_prefix_traffic(cfg, reqs, num_slots=args.slots,
                                          max_len=args.max_len,
                                          seed=args.seed, meter=meter)
        summary = None
        end = sim.total_time
        source_trace = sim.trace
        n_served = len(reqs)

    rep = meter.report(end)
    # exactness receipt: the streamed integral against the offline scalar
    # reference on the source trace (not the meter's own mirror)
    dur, occ = source_trace.occupancy_series(end, use="needed")
    ref = evaluate(dur, occ, capacity=meter.capacity, banks=meter.banks,
                   policy=meter.policy, n_reads=0, n_writes=0,
                   char=meter.char)
    exact = (rep.result.e_leak == ref.e_leak
             and rep.result.e_sw == ref.e_sw
             and rep.result.n_transitions == ref.n_transitions)
    print(f"metered {n_served} requests over {end:.3f}s "
          f"({meter.n_events} ledger events)")
    print()
    print(rep.format())
    print(f"  exact vs offline gating.evaluate: "
          f"{'MATCH (bit-identical f64)' if exact else 'MISMATCH'}")
    if not exact:
        raise SystemExit(1)
    if summary is not None:
        print()
        print(summary.format())
    if args.out:
        export_chrome_trace(args.out, meter=meter, end_time=end)
        print(f"\nwrote {args.out} ({meter.banks} bank-state lanes + energy "
              f"counters) — load it at ui.perfetto.dev")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("report", "export"):
        p = sub.add_parser(name)
        p.add_argument("--arch", default="dsr1d_qwen_1_5b")
        p.add_argument("--layers", type=int, default=2,
                       help="reduced-config layer count (CPU-sized)")
        p.add_argument("--requests", type=int, default=8)
        p.add_argument("--new-tokens", type=int, default=8)
        p.add_argument("--slots", type=int, default=2)
        p.add_argument("--page-size", type=int, default=8)
        p.add_argument("--num-pages", type=int, default=64)
        p.add_argument("--chunk-steps", type=int, default=4)
        p.add_argument("--prefix", action="store_true",
                       help="enable the prefix cache (adds COW/eviction "
                            "spans and the dual kv_logical track)")
        p.add_argument("--prefix-len", type=int, default=24)
        p.add_argument("--sharing", type=int, default=4)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="device of the served model: the CUDA kernels "
                            "on the card, or the plain PyTorch path")
        if name == "export":
            p.add_argument("--out", default="obs_trace.json")
    pe = sub.add_parser(
        "energy", help="streaming bank-energy meter: report, live "
                       "dashboard (--watch) or Perfetto export (--out)")
    pe.add_argument("--arch", default="dsr1d_qwen_1_5b")
    pe.add_argument("--meter", default="32,8,0.9,conservative",
                    metavar="C,B[,alpha[,policy]]",
                    help="meter candidate: capacity [MiB], banks, alpha, "
                         "policy")
    pe.add_argument("--serve", action="store_true",
                    help="drive the real paged serve (reduced model) "
                         "instead of the model-free traffic simulator")
    pe.add_argument("--workload", default="chat_sysprompt",
                    choices=["plain", "chat_sysprompt", "fewshot",
                             "agentic_fanout"])
    pe.add_argument("--rate", type=float, default=6.0)
    pe.add_argument("--horizon", type=float, default=8.0)
    pe.add_argument("--slots", type=int, default=4)
    pe.add_argument("--max-len", type=int, default=512)
    pe.add_argument("--sharing", type=int, default=4)
    pe.add_argument("--prefix-len", type=int, default=128)
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--watch", action="store_true",
                    help="print the live dashboard as the stream advances")
    pe.add_argument("--interval", type=float, default=1.0,
                    help="--watch refresh interval [sim s]")
    pe.add_argument("--out", default=None,
                    help="also export a Perfetto trace with bank-state "
                         "lanes + energy counter tracks")
    # serve-path knobs (reduced model)
    pe.add_argument("--layers", type=int, default=2)
    pe.add_argument("--requests", type=int, default=8)
    pe.add_argument("--new-tokens", type=int, default=8)
    pe.add_argument("--page-size", type=int, default=8)
    pe.add_argument("--num-pages", type=int, default=64)
    pe.add_argument("--chunk-steps", type=int, default=4)
    pe.add_argument("--prefix", action="store_true")
    pe.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the --serve model")
    args = ap.parse_args()
    args.device = require_device(args.device)

    if args.cmd == "energy":
        run_energy(args)
        return

    tel, cb, done = run_serve(args)
    summary = cb.slo_summary()
    print(f"served {len(done)} requests on {args.slots} slots "
          f"({cb.stats.chunks} chunks, {cb.stats.decode_steps} decode steps)")

    if args.cmd == "report":
        print()
        print(tel.format())
        print()
        print(summary.format())
        return

    bundle = cb.occupancy_bundle()
    export_chrome_trace(args.out, tel, traces=bundle.traces.values(),
                        end_time=bundle.total_time,
                        other_data={"slo": asdict(summary),
                                    "counters": tel.snapshot()["counters"]})
    print(f"wrote {args.out} ({len(tel.spans)} spans, "
          f"{len(bundle.traces)} counter tracks) — load it at "
          f"ui.perfetto.dev or chrome://tracing")
    print(f"ttft p99 = {summary.ttft_p99_s:.4f}s, "
          f"tbt p99 = {summary.tbt_p99_s:.4f}s over "
          f"{summary.n_requests} requests")


if __name__ == "__main__":
    main()
