"""Observability walkthrough on the port: telemetry-enabled prefix-sharing
serve -> registry report -> serving SLO percentiles -> Perfetto timeline on
disk. Counterpart of the reference's `examples/obs_timeline.py`.

  1. a `chat_sysprompt` workload is drawn from the seeded traffic
     generators and served by `PagedContinuousBatcher(prefix_cache=True)`
     with an enabled `Telemetry` registry: every admission, prefill,
     decode chunk, COW split and retirement lands in counters, gauges,
     histograms and spans on the batcher's logical sim clock;
  2. the registry prints as a flat metrics report, and per-request
     TTFT / time-between-tokens / e2e latencies come back as p50/p90/p99
     through `cb.slo_summary()`;
  3. `export_chrome_trace` writes the spans plus the Stage-I KV-occupancy
     traces (physical and logical) as one Chrome-trace-event JSON, loadable
     at https://ui.perfetto.dev or chrome://tracing.

Run on the card:   PYTHONPATH=src python -m repro_torch.examples.obs_timeline
Run on the CPU:    PYTHONPATH=src python -m repro_torch.examples.obs_timeline \
                       --device cpu
"""
from __future__ import annotations

import argparse
from dataclasses import asdict

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.models import DecoderLM
from repro_torch.obs import Telemetry, export_chrome_trace
from repro_torch.params import init_params
from repro_torch.serve import PagedContinuousBatcher, Request
from repro_torch.traffic import (LengthModel, generate_workload,
                                 materialize_tokens)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--prefix-len", type=int, default=48)
    ap.add_argument("--sharing", type=int, default=4)
    ap.add_argument("--out", default="obs_timeline.json")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    cfg = reduced(get_arch(args.arch))
    model = DecoderLM(cfg, compute_dtype=torch.float32, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(0)
    params = init_params(cfg, gen, device=model.device)

    # ---- telemetry-enabled serve ----------------------------------------
    lengths = LengthModel(prompt_mean=16.0, prompt_sigma=0.4,
                          output_mean=args.new_tokens, max_len=96)
    specs = generate_workload("chat_sysprompt", rate=4.0,
                              horizon_s=float(args.requests), seed=0,
                              lengths=lengths, prefix_len=args.prefix_len,
                              sharing=args.sharing)[:args.requests]
    tokens = materialize_tokens(specs, cfg.vocab_size, seed=0)

    tel = Telemetry(enabled=True)
    cb = PagedContinuousBatcher(
        model, params, num_slots=args.slots, page_size=args.page_size,
        num_pages=128, chunk_steps=8, prefix_cache=True, telemetry=tel)
    for s, toks in zip(specs, tokens):
        cb.submit(Request(rid=s.rid, tokens=np.asarray(toks),
                          max_new_tokens=max(s.output_len, 2)))
    done = cb.run()
    print(f"served {len(done)} requests on {args.slots} slots "
          f"({cb.stats.chunks} chunks, {cb.stats.decode_steps} decode steps,"
          f" {cb.stats.prefix_hits} prefix hits) on {model.device}")

    # ---- registry report + SLO percentiles ------------------------------
    print()
    print(tel.format())
    summary = cb.slo_summary()
    print()
    print(summary.format())

    # ---- Perfetto timeline ----------------------------------------------
    bundle = cb.occupancy_bundle()
    export_chrome_trace(args.out, tel, traces=bundle.traces.values(),
                        end_time=bundle.total_time,
                        other_data={"slo": asdict(summary)})
    print(f"\nwrote {args.out} ({len(tel.spans)} spans, "
          f"{len(bundle.traces)} counter tracks) — load it at "
          f"ui.perfetto.dev or chrome://tracing: request lanes under "
          f"'requests', slot lanes + KV occupancy under 'serving'")


if __name__ == "__main__":
    main()
