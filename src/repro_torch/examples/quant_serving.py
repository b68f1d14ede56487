"""Quantized-KV serving walkthrough on the port: float vs int8 vs fp8 page
pools. Counterpart of the reference's `examples/quant_serving.py`.

Runs the SAME request stream through three `PagedContinuousBatcher`s that
differ only in `kv_dtype`, then shows each link of the accuracy-vs-energy
chain:

  1. bytes per page per kv_dtype (`serve.paged.page_bytes`): int8 carries a
     4-byte float32 scale per (page, KV head, row), fp8 E4M3 is scale-free
     at 1 byte per element;
  2. accuracy: the largest logit error and greedy-token agreement of the
     quantized runs against the float batcher (`collect_logits=True`);
  3. Stage II: each batcher's byte-accurate occupancy trace gated at the
     SAME capacity, sized to the float run's peak: smaller pages leave more
     banks idle, which power gating turns into energy.

The float run is "fp32" for the reduced float32 model and "native" (bf16)
at full width. The reference's telemetry columns (`kv_bytes_physical`,
`quant.dequant_pages`) wait for the port's telemetry.

Run on the card:   PYTHONPATH=src python -m repro_torch.examples.quant_serving
Run on the CPU:    PYTHONPATH=src python -m repro_torch.examples.quant_serving \
                       --device cpu
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core.candidates import (CandidateEnergies,
                                         evaluate_candidates, make_grid)
from repro_torch.models import DecoderLM
from repro_torch.params import init_params
from repro_torch.serve import PagedContinuousBatcher, Request
from repro_torch.sim.trace import TraceBundle


def serve_stream(model, params, prompts: Sequence[np.ndarray], kv_dtype: str,
                 new_tokens: int, **geometry):
    """Serve `prompts` (greedy, `new_tokens` each) through one batcher
    whose pages hold `kv_dtype`. Returns (batcher, finished requests sorted
    by rid)."""
    cb = PagedContinuousBatcher(model, params, kv_dtype=kv_dtype, **geometry)
    for i, p in enumerate(prompts):
        cb.submit(Request(rid=i, tokens=p, max_new_tokens=new_tokens))
    return cb, sorted(cb.run(), key=lambda r: r.rid)


def agreement(a: List[Request], b: List[Request]) -> int:
    """Requests whose greedy outputs are equal, of two runs sorted by rid."""
    return sum(x.output == y.output for x, y in zip(a, b))


def gate_at_capacity(bundles: Dict[str, TraceBundle], capacity: int,
                     banks: int = 8, device="cuda"
                     ) -> Dict[str, CandidateEnergies]:
    """Stage II of each trace at one KV SRAM (capacity bytes, `banks`
    banks, alpha 1.0, threshold gating): {name: its CandidateEnergies}."""
    cands = make_grid([capacity], [banks], alphas=(1.0,))
    out = {}
    for name, b in bundles.items():
        dur, occ = b.traces["kv"].occupancy_series(b.total_time,
                                                   use="needed")
        out[name] = evaluate_candidates(
            dur, occ, cands, n_reads=b.access.n_reads("kv"),
            n_writes=b.access.n_writes("kv"), device=device)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="any registry arch (repro_torch.configs)")
    ap.add_argument("--full-width", action="store_true",
                    help="the config's published widths (default: reduced)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--page-size", type=int, default=8)
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
    prompts = [rng.integers(0, cfg.vocab_size, args.prompt_len)
               for _ in range(args.requests)]

    base = "fp32" if dtype == torch.float32 else "native"
    names = (base, "int8", "fp8")
    per_slot = -(-(args.prompt_len + args.new_tokens) // args.page_size)
    geometry = dict(num_slots=args.slots, page_size=args.page_size,
                    num_pages=args.slots * per_slot + 1,
                    max_pages_per_slot=per_slot, chunk_steps=4,
                    collect_logits=True)
    runs = {dt: serve_stream(model, params, prompts, dt, args.new_tokens,
                             **geometry) for dt in names}

    # ---- bytes + accuracy -----------------------------------------------
    print(f"quant-serve: {args.requests} requests x {args.new_tokens} new "
          f"tokens on {cfg.name} ({dtype}, {model.device})")
    print(f"\n{'kv_dtype':>8} {'B/page':>9} {'vs ' + base:>10} "
          f"{'logit_err':>10} {'tokens':>7}")
    base_cb, base_done = runs[base]
    for dt in names:
        cb, done = runs[dt]
        err = max(float(np.abs(np.stack(r.logits) - np.stack(f.logits)).max())
                  for r, f in zip(done, base_done))
        agree = agreement(done, base_done)
        print(f"{dt:>8} {cb.page_bytes:>9} "
              f"{base_cb.page_bytes / cb.page_bytes:>9.2f}x "
              f"{err:>10.2e} {agree:>3}/{len(done):<3}")

    # ---- Stage II: gate the float-peak-sized KV SRAM against each trace --
    # Capacity is fixed at what the float cache needs; the quantized traces
    # occupy proportionally fewer bytes of it, so more banks sit idle and
    # power gating converts the gap into energy.
    bundles = {dt: cb.occupancy_bundle() for dt, (cb, _) in runs.items()}
    cap = max(bundles[base].traces["kv"].peak_needed(), 1)
    energies = gate_at_capacity(bundles, cap, device=model.device)
    print(f"\n# Stage II: {base}-peak-sized KV SRAM (C={cap} B, B=8) gated "
          f"against each dtype's byte-accurate trace")
    print(f"{'kv_dtype':>8} {'peak_KiB':>9} {'E[mJ]':>9} {'vs ' + base:>10}")
    e_base = float(energies[base].e_total[0])
    for dt in names:
        e = float(energies[dt].e_total[0])
        peak = bundles[dt].traces["kv"].peak_needed()
        print(f"{dt:>8} {peak // 1024:>9} {e * 1e3:>9.3f} "
              f"{(1 - e / e_base) * 100:>+9.1f}%")
    print("\nsmaller pages -> lower occupancy at the same capacity -> more "
          "gate-eligible banks: the last column is the extra gating energy "
          "the quantized KV cache unlocks.")


if __name__ == "__main__":
    main()
