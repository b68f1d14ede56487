"""SLA-aware serving walkthrough on the port: chunked prefill, priority
preemption, and forecast-driven bank pre-wake, the three layers of the
serving SLA story. Counterpart of the reference's `examples/sla_serving.py`.

  1. chunked prefill: a long prompt admits in page-aligned slices with
     decode chunks interleaved (each later slice a prefill with a query
     offset), so active streams keep their token cadence: p99
     time-between-tokens, read from the batcher's telemetry on its logical
     clock, falls while greedy tokens stay equal to the monolithic
     prefill's;
  2. priority preemption: a high-priority arrival evicts the lowest-
     priority slot (pages freed through the retire path, the victim
     requeued for an exact from-scratch replay) instead of queueing;
  3. forecast pre-wake: the PSS-style affine extrapolator pointed at the
     occupancy series wakes SRAM banks just before demand returns, cutting
     wake-latency violations at bounded extra leakage against the offline
     oracle (whose legs run the `exact_bank_stats` kernel on `--device`).

Run on the card:   PYTHONPATH=src python -m repro_torch.examples.sla_serving
Run on the CPU:    PYTHONPATH=src python -m repro_torch.examples.sla_serving \
                       --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.models import DecoderLM
from repro_torch.obs import Telemetry
from repro_torch.params import init_params
from repro_torch.serve import PagedContinuousBatcher, Request
from repro_torch.traffic import (ControllerConfig, LengthModel, generate,
                                 simulate_traffic)
from repro_torch.traffic.controller import ForecastConfig, compare


def _interleave(model, params, chunk_tokens, *, slots, new_tokens):
    cfg = model.cfg
    rng = np.random.default_rng(0)
    cb = PagedContinuousBatcher(
        model, params, num_slots=slots, page_size=16, num_pages=64,
        max_pages_per_slot=12, chunk_steps=8,
        prefill_chunk_tokens=chunk_tokens, telemetry=Telemetry(enabled=True))
    for i in range(3):                              # streaming shorts
        cb.submit(Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, 8),
                          max_new_tokens=new_tokens))
    for i in range(2):                              # fat prompts
        cb.submit(Request(rid=3 + i,
                          tokens=rng.integers(0, cfg.vocab_size, 128),
                          max_new_tokens=8))
    done = cb.run()
    return cb.slo_summary(), {r.rid: list(r.output) for r in done}, cb


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--chunk-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = reduced(get_arch(args.arch))
    model = DecoderLM(cfg, compute_dtype=torch.float32, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=model.device)

    # ---- 1. chunked prefill under long-prompt interleave -----------------
    mono, mono_toks, _ = _interleave(model, params, None,
                                     slots=args.slots,
                                     new_tokens=args.new_tokens)
    chnk, chnk_toks, ccb = _interleave(model, params, args.chunk_tokens,
                                       slots=args.slots,
                                       new_tokens=args.new_tokens)
    same = mono_toks == chnk_toks
    print(f"sla-serve arch={cfg.name} device={model.device} "
          f"slots={args.slots} chunk={args.chunk_tokens} tok")
    print(f"chunked prefill: {ccb.stats.prefill_slices} slices, tokens "
          f"equal to monolithic: {same}")
    print(f"  p99 TBT  mono={mono.tbt_p99_s*1e3:.2f}ms  "
          f"chunked={chnk.tbt_p99_s*1e3:.2f}ms  "
          f"({chnk.tbt_p99_s / mono.tbt_p99_s:.2f}x)")

    # ---- 2. priority preemption ------------------------------------------
    rng = np.random.default_rng(1)
    cb = PagedContinuousBatcher(model, params, num_slots=1, page_size=8,
                                num_pages=32, max_pages_per_slot=8,
                                chunk_steps=2)
    cb.submit(Request(rid=0, tokens=rng.integers(0, cfg.vocab_size, 10),
                      max_new_tokens=20, priority=0))
    started: list = []
    cb._admit(started)
    cb._decode_chunk(started)                     # rid=0 is mid-decode...
    cb.submit(Request(rid=1, tokens=rng.integers(0, cfg.vocab_size, 10),
                      max_new_tokens=8, priority=1))
    done = started + cb.run()                     # ...and gets preempted
    order = [r.rid for r in done]
    victim = next(r for r in done if r.rid == 0)
    print(f"\npriority preemption: finish order {order}, "
          f"rid=0 preempted {victim.preemptions}x and replayed "
          f"({len(victim.output)} tokens, exact restart)")

    # ---- 3. forecast pre-wake on diurnal traffic -------------------------
    reqs = generate("diurnal", 6.0, 20.0, seed=0,
                    lengths=LengthModel(max_len=2048))
    sim = simulate_traffic(get_arch("tinyllama-1.1b"), reqs, num_slots=8,
                           max_len=2048)
    dur, occ = sim.trace.occupancy_series(sim.total_time, use="needed")
    c = compare(dur, occ, capacity=32 * 2**20, banks=8,
                n_reads=sim.bundle.access.n_reads("kv"),
                n_writes=sim.bundle.access.n_writes("kv"),
                cfg=ControllerConfig(), fcfg=ForecastConfig(),
                device=model.device)
    print("\nforecast pre-wake vs reactive vs oracle "
          "(diurnal@6/s, C=32MiB, B=8):")
    print("  " + c.format().replace("\n", "\n  "))
    f = c.forecast
    print(f"  -> {c.online.wake_violations - f.wake_violations} violations "
          f"avoided for {f.early_wake_s*1e3:.1f}ms early-wake leakage "
          f"({c.forecast_vs_oracle_pct:+.1f}% energy vs oracle)")


if __name__ == "__main__":
    main()
