"""Paged KV-cache serving walkthrough on the port: ragged requests stream
through the paged continuous batcher, and its page-granular occupancy trace
feeds a Stage-II (capacity, banks) sweep — the paper's two-stage flow driven
by live serving. Counterpart of the reference's `examples/paged_serving.py`.

Run on the card:   PYTHONPATH=src python -m repro_torch.examples.paged_serving
Run on the CPU:    PYTHONPATH=src python -m repro_torch.examples.paged_serving \
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
from repro_torch.serve import PagedContinuousBatcher, Request


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dsr1d-qwen-1.5b",
                    choices=["dsr1d-qwen-1.5b", "gpt2-xl"])
    ap.add_argument("--full-width", action="store_true",
                    help="the config's published widths (default: reduced)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--chunk-steps", type=int, default=8)
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
    prompts = [rng.integers(0, cfg.vocab_size, 5 + 4 * i)
               for i in range(args.requests)]
    longest = max(len(p) for p in prompts) + args.new_tokens
    per_slot = -(-longest // args.page_size)
    cb = PagedContinuousBatcher(
        model, params, num_slots=args.slots, page_size=args.page_size,
        num_pages=args.slots * per_slot + 1, max_pages_per_slot=per_slot,
        chunk_steps=args.chunk_steps)
    for i, p in enumerate(prompts):
        cb.submit(Request(rid=i, tokens=p, max_new_tokens=args.new_tokens))
    done = cb.run()

    st = cb.stats
    print(f"arch={cfg.name} device={model.device} slots={args.slots} "
          f"page_size={args.page_size} page_bytes={cb.page_bytes}")
    print(f"finished {st.finished}/{st.admitted} requests in {st.chunks} "
          f"chunks ({st.decode_steps} decode steps, {st.prefills} prefills)")
    print(f"pages: {st.pages_allocated} allocated / {st.pages_freed} freed, "
          f"peak {st.peak_pages} resident "
          f"({st.peak_pages * cb.page_bytes} bytes)")
    for r in done[:3]:
        print(f"  rid={r.rid} prompt={len(r.tokens)} -> {r.output[:6]}...")

    # ---- Stage II over the page-granular serving trace -------------------
    bundle = cb.occupancy_bundle()
    tr = bundle.traces["kv"]
    print(f"\ntrace: {tr.n_events} page alloc/free events, "
          f"peak {tr.peak_needed()} B "
          f"({tr.peak_needed() // cb.page_bytes} pages), "
          f"drained to {int(tr.as_arrays()[1][-1])} B")
    m = min_capacity_mib(tr.peak_needed())
    table = sweep(bundle, mem_name="kv", capacities_mib=[m, m + 16],
                  banks=[1, 2, 4, 8], device=args.device)
    print()
    print(table.format())
    best = table.best()
    print(f"\nbest: C={best.capacity_mib} MiB B={best.banks} "
          f"-> {best.result.e_total * 1e3:.2f} mJ")


if __name__ == "__main__":
    main()
