"""Prefix-sharing serving walkthrough on the port: shared-prefix traffic ->
radix-index prefill skip -> the physical and logical occupancy traces ->
a Stage-II sweep of each, and the power-gating headroom sharing frees.
Counterpart of the reference's `examples/prefix_serving.py`.

  1. a `chat_sysprompt` workload (tenants share system prompts) is drawn
     from the seeded traffic generators and materialized into token
     streams whose leading tokens coincide;
  2. `PagedContinuousBatcher(prefix_cache=True)` admits them: the radix
     index maps cached pages into each slot's page table, only the suffix
     is prefilled (the prefill kernel with a query offset), the last page
     of a shared run is split copy-on-write at the first divergent write,
     and unreferenced cached prefixes are LRU-evicted under pressure;
  3. the ledger emits "kv_logical" (what the slots demand) and "kv" (the
     unique pages resident, never more);
  4. `core.explorer.sweep` prices (capacity, banks) against both, and the
     KV SRAM sized for the logical peak is gated against each: the energy
     gap is the headroom sharing frees.

Run on the card:   PYTHONPATH=src python -m repro_torch.examples.prefix_serving
Run on the CPU:    PYTHONPATH=src python -m \
                       repro_torch.examples.prefix_serving --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core.candidates import evaluate_candidates, make_grid
from repro_torch.core.explorer import min_capacity_mib, sweep
from repro_torch.models import DecoderLM
from repro_torch.params import init_params
from repro_torch.serve import PagedContinuousBatcher, Request
from repro_torch.traffic import (LengthModel, generate_workload,
                                 materialize_tokens)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="any registry arch (repro_torch.configs)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--prefix-len", type=int, default=48)
    ap.add_argument("--sharing", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = reduced(get_arch(args.arch))
    model = DecoderLM(cfg, compute_dtype=torch.float32, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=model.device)

    # ---- shared-prefix traffic ------------------------------------------
    lengths = LengthModel(prompt_mean=16.0, prompt_sigma=0.4,
                          output_mean=args.new_tokens, max_len=96)
    specs = generate_workload("chat_sysprompt", rate=4.0,
                              horizon_s=args.requests / 4.0, seed=args.seed,
                              lengths=lengths, prefix_len=args.prefix_len,
                              sharing=args.sharing)[:args.requests]
    tokens = materialize_tokens(specs, cfg.vocab_size, seed=args.seed)
    print(f"arch={cfg.name} device={model.device}; workload: {len(specs)} "
          f"requests, {len({s.prefix_id for s in specs})} tenants, "
          f"prefix~{args.prefix_len} tok, sharing~{args.sharing}")

    cb = PagedContinuousBatcher(
        model, params, num_slots=args.slots, page_size=args.page_size,
        num_pages=128, chunk_steps=8, prefix_cache=True)
    for s, toks in zip(specs, tokens):
        cb.submit(Request(rid=s.rid, tokens=np.asarray(toks),
                          max_new_tokens=max(s.output_len, 2)))
    done = cb.run()

    st = cb.stats
    total_prompt = sum(s.prompt_len for s in specs)
    print(f"finished {st.finished}/{st.admitted}: prefix hits "
          f"{st.prefix_hits}, {st.prefix_tokens_reused}/{total_prompt} "
          f"prompt tokens reused ({st.prefix_tokens_reused / total_prompt:.0%}"
          f" prefill skipped), {st.cow_splits} COW splits, "
          f"{st.evicted_pages} pages evicted")
    for r in done[:3]:
        print(f"  rid={r.rid} prompt={len(r.tokens)} -> {r.output[:5]}...")

    # ---- the two occupancy traces ---------------------------------------
    bundle = cb.occupancy_bundle()
    phys = bundle.traces["kv"]
    logi = bundle.traces["kv_logical"]
    pb = cb.page_bytes
    print(f"\noccupancy: logical peak {logi.peak_needed() // pb} pages, "
          f"physical peak {phys.peak_needed() // pb} pages "
          f"({logi.peak_needed() / max(phys.peak_needed(), 1):.2f}x lower), "
          f"cache-resident peak {phys.peak_total() // pb} pages")

    # ---- Stage II on both views -----------------------------------------
    for name in ("kv", "kv_logical"):
        m = min_capacity_mib(bundle.traces[name].peak_needed())
        table = sweep(bundle, mem_name=name, capacities_mib=[m, m + 16],
                      banks=[1, 2, 4, 8], device=args.device)
        best = table.best()
        print(f"\n# Stage II vs {name} occupancy")
        print(table.format())
        print(f"best: C={best.capacity_mib} MiB B={best.banks} -> "
              f"{best.result.e_total * 1e3:.3f} mJ")

    # gating headroom at the design point a non-sharing allocator needs:
    # capacity sized to the logical peak, gated by what actually resides
    cap = max(logi.peak_needed(), pb)
    cands = make_grid([cap], [8], alphas=(1.0,))
    n_r = bundle.access.n_reads("kv")
    n_w = bundle.access.n_writes("kv")
    out = []
    for tr in (logi, phys):
        dur, occ = tr.occupancy_series(bundle.total_time, use="needed")
        out.append(evaluate_candidates(dur, occ, cands, n_reads=n_r,
                                       n_writes=n_w,
                                       device=args.device).e_total[0])
    e_logical, e_physical = out
    print(f"\ngating the logical-peak-sized KV SRAM (C={cap} B, B=8):")
    print(f"  against logical demand : {e_logical * 1e3:.3f} mJ")
    print(f"  against physical pages : {e_physical * 1e3:.3f} mJ")
    print(f"extra power-gating savings unlocked by prefix sharing: "
          f"{(1 - e_physical / e_logical) * 100:.1f}%")


if __name__ == "__main__":
    main()
