"""Dense serving walkthrough on the port: `BatchedServer` prefills a batch
of prompts and decodes with a static dense KV cache (prefill latency,
decode tokens/s), then `ContinuousBatcher` serves ragged requests through
per-slot dense caches and its slot-occupancy trace feeds a Stage-II
(capacity, banks) sweep. Counterpart of the reference's
`examples/serve_batched.py`; every decode step attends through the dense
GQA decode kernel (its plain version on the CPU).

Run on the card:   PYTHONPATH=src python -m repro_torch.examples.serve_batched
Run on the CPU:    PYTHONPATH=src python -m repro_torch.examples.serve_batched \
                       --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core.explorer import min_capacity_mib, sweep
from repro_torch.models import DecoderLM
from repro_torch.params import init_params
from repro_torch.serve import (BatchedServer, ContinuousBatcher, Request,
                               ServeConfig)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dsr1d-qwen-1.5b",
                    choices=["dsr1d-qwen-1.5b", "gpt2-xl"])
    ap.add_argument("--full-width", action="store_true",
                    help="the config's published widths (default: reduced)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_arch(args.arch)
    if not args.full_width:
        cfg = reduced(cfg)
    dtype = torch.bfloat16 if args.full_width else torch.float32
    model = DecoderLM(cfg, compute_dtype=dtype, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=model.device, dtype=dtype)
    rng = np.random.default_rng(args.seed)

    # ---- BatchedServer: one lockstep batch -------------------------------
    max_len = args.prompt_len + args.new_tokens + 8
    srv = BatchedServer(model, params, ServeConfig(
        max_len=max_len, max_new_tokens=args.new_tokens,
        temperature=args.temperature, seed=args.seed))
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    res = srv.generate({"tokens": prompts})
    st = res["stats"]
    print(f"arch={cfg.name} device={model.device} batch={args.batch} "
          f"prompt={args.prompt_len} new={args.new_tokens}")
    print(f"prefill: {st.prefill_s * 1e3:.1f} ms "
          f"({args.batch * args.prompt_len / st.prefill_s:.0f} tok/s)")
    print(f"decode:  {st.decode_s * 1e3:.1f} ms "
          f"({st.decode_tokens_per_s:.0f} tok/s)")
    print(f"first generated rows:\n{res['tokens'][:2]}")

    # ---- ContinuousBatcher: ragged requests -> slot trace -> (C, B) ------
    cb = ContinuousBatcher(model, params, num_slots=args.slots,
                           max_len=max_len)
    for i in range(2 * args.slots):
        cb.submit(Request(rid=i, tokens=rng.integers(
            0, cfg.vocab_size, 5 + 7 * i), max_new_tokens=args.new_tokens))
    done = cb.run()
    s = cb.stats
    tr = cb.trace
    print(f"\ncontinuous batcher: {s.finished}/{s.admitted} requests, "
          f"{s.decode_steps} decode steps, peak {tr.peak_needed()} B of KV, "
          f"drained to {int(tr.as_arrays()[1][-1])} B")
    for r in done[:2]:
        print(f"  rid={r.rid} prompt={len(r.tokens)} -> {r.output[:6]}...")
    m = min_capacity_mib(tr.peak_needed())
    table = sweep(cb.occupancy_bundle(), mem_name="kv",
                  capacities_mib=[m, m + 1], banks=[1, 2, 4, 8],
                  device=args.device)
    print()
    print(table.format())


if __name__ == "__main__":
    main()
