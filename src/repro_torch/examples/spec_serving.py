"""Speculative-decoding serving walkthrough on the port: draft and target on
one page pool -> batched k-token verification -> rollback by page
truncation -> the occupancy signature Stage II prices. Counterpart of the
reference's `examples/spec_serving.py`:

  1. `PagedContinuousBatcher(speculate_k=k)` runs a self-speculation draft
     (every 2nd layer of the target, same weights) that proposes k tokens
     per round; the target scores all k + 1 window rows in one
     `paged_gqa_verify` call per layer;
  2. acceptance keeps the longest drafted prefix that matches the target's
     argmax, so the emitted tokens equal the non-speculative loop's: the
     draft changes how fast tokens arrive, never which;
  3. both lanes burst to the verify window each round, and `truncate_rows`
     rolls the rejected suffix back: the trace gets negative mid-stream
     deltas, and the (C, B) sweep prices both live traces;
  4. the model-free `simulate_spec_traffic` sweeps acceptance rates at full
     width: lower acceptance gives a taller per-round sawtooth on both page
     lanes, and Stage II prices the acceptance-0.6 trace.

Run on the card:   PYTHONPATH=src python -m repro_torch.examples.spec_serving
Run on the CPU:    PYTHONPATH=src python -m repro_torch.examples.spec_serving \
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
from repro_torch.traffic import (LengthModel, generate,
                                 simulate_spec_traffic)

MIB = 2**20


def run(model, params, prompts, new_tokens, **kw):
    cb = PagedContinuousBatcher(model, params, num_slots=2, page_size=8,
                                num_pages=96, max_pages_per_slot=10,
                                chunk_steps=4, **kw)
    for i, p in enumerate(prompts):
        cb.submit(Request(rid=i, tokens=p, max_new_tokens=new_tokens))
    done = cb.run()
    return {r.rid: list(r.output) for r in done}, cb


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="any registry arch (repro_torch.configs)")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--speculate", type=int, default=3)
    ap.add_argument("--new-tokens", type=int, default=14)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = reduced(get_arch(args.arch), layers=args.layers)
    model = DecoderLM(cfg, compute_dtype=torch.float32, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=model.device)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 13, 6)]

    # ---- the acceptance guarantee, live ----------------------------------
    ref, plain = run(model, params, prompts, args.new_tokens)
    got, cb = run(model, params, prompts, args.new_tokens,
                  speculate_k=args.speculate)
    st = cb.stats
    k = args.speculate
    print(f"arch={cfg.name} device={model.device} speculate_k={k} "
          f"(self-speculation, skip=2: {cb.draft_model.cfg.num_layers}/"
          f"{cfg.num_layers} layers draft)")
    print(f"tokens equal to the non-speculative loop's: {got == ref}")
    print(f"  {st.spec_rounds} verify rounds, {st.drafted_tokens} drafted, "
          f"{st.accepted_tokens} tokens accepted "
          f"({st.accepted_tokens / max(st.spec_rounds, 1):.2f}/{k + 1} per "
          f"round), {st.rolled_back_pages} pages rolled back by truncation")
    saved = st.accepted_tokens - st.spec_rounds
    print(f"  sequential target decode steps avoided: {saved} "
          f"({saved / max(st.accepted_tokens, 1):.0%} of tokens)")

    # ---- the occupancy signature -----------------------------------------
    tr = cb.ledger.trace
    ev = np.asarray(tr.ev_dneeded)
    print(f"\ntrace: {len(ev)} page events, {int((ev < 0).sum())} negative "
          f"({int((ev < 0).sum()) - 2 * st.finished} mid-stream rollbacks), "
          f"peak {tr.peak_needed()} B vs {plain.ledger.trace.peak_needed()} "
          f"B without speculation, drained to {int(tr.as_arrays()[1][-1])} B")

    # ---- Stage II prices both live traces --------------------------------
    for name, b in (("non-speculative", plain), ("speculative", cb)):
        bundle = b.occupancy_bundle()
        m = min_capacity_mib(bundle.traces["kv"].peak_needed())
        table = sweep(bundle, mem_name="kv", capacities_mib=[m, m + 1],
                      banks=[1, 2, 4, 8], device=args.device)
        best = table.best()
        print(f"\n# Stage-II sweep, {name} trace")
        print(table.format())
        print(f"best: C={best.capacity_mib} MiB B={best.banks} -> "
              f"{best.result.e_total * 1e3:.3f} mJ")

    # ---- acceptance rate -> occupancy signature --------------------------
    # the model-free simulator sweeps what the serving path just produced:
    # higher rejection = taller per-round sawtooth (burst to the verify
    # window, rollback to the accepted context) on both page lanes
    full = get_arch(args.arch)
    lengths = LengthModel(max_len=512)
    reqs = generate("poisson", 6.0, 10.0, seed=0, lengths=lengths)
    print(f"\nmodel-free sweep: {len(reqs)} requests, k=4, draft=0.5x "
          f"({full.name})")
    print(f"  {'accept':>6} {'tok/round':>9} {'rolled-back':>11} "
          f"{'peak[MiB]':>9} {'mean[MiB]':>9}")
    sims = {}
    for acc in (0.3, 0.6, 0.9):
        sim = simulate_spec_traffic(full, reqs, num_slots=8, max_len=512,
                                    spec_k=4, acceptance=acc,
                                    draft_kv_frac=0.5, seed=0)
        sims[acc] = sim
        s = sim.stats
        tr = sim.trace
        print(f"  {acc:>6.1f} "
              f"{s.accepted_tokens / max(s.spec_rounds, 1):>9.2f} "
              f"{s.rolled_back_pages:>11} "
              f"{tr.peak_needed() / MIB:>9.1f} "
              f"{tr.time_weighted_mean(sim.total_time) / MIB:>9.1f}")

    # ---- Stage II prices the signature -----------------------------------
    # the sawtooth widens the gap between peak (what capacity must cover)
    # and mean (what leakage actually pays after gating)
    print("\n# Stage-II sweep on the acceptance=0.6 spec trace")
    table = sweep(sims[0.6].bundle, mem_name="kv", capacities_mib=[16, 32],
                  banks=[1, 4, 8, 16], device=args.device)
    print(table.format())


if __name__ == "__main__":
    main()
