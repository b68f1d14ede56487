"""The decoder families on the port's three batchers, each serving trace
swept by Stage II: olmoe (MoE) through `PagedContinuousBatcher`,
recurrentgemma (RG-LRU + sliding-window rings, whose KV saturates at the
window while the recurrent state stays fixed) and llama4-scout (chunked
rings + one full layer, MoE with a shared expert) through
`ContinuousBatcher`, mamba2 (SSD blocks only: pages priced at 0 bytes,
state dense per slot) through both, and internvl2 with its 256 prefix
embeddings through `BatchedServer`.

Full-attention layers prefill through the prefill kernel and decode
through the paged or dense decode kernel; local and chunked layers decode
through the dense decode kernel on their rings (plain PyTorch on the CPU).
`FAMILIES` holds each family's run at full width and reduced;
`serve_family` serves one run and returns what it launched per kernel
(layers x calls), which `chip_smoke.py` holds against the counted launches.

Run on the card (full width, bf16, random weights):
    PYTHONPATH=src python -m repro_torch.examples.families_serving --full
Run on the CPU (reduced configs, float32):
    PYTHONPATH=src python -m repro_torch.examples.families_serving \
        --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core.explorer import min_capacity_mib, sweep
from repro_torch.models import DecoderLM
from repro_torch.params import init_params
from repro_torch.serve import (BatchedServer, ContinuousBatcher,
                               PagedContinuousBatcher, Request, ServeConfig)

# one run per family: the batchers it is served by, prompt lengths and new
# tokens at full width and reduced (prompts meet the reference's shape
# rules: a window's or SSD chunk's length divides a longer prompt), the
# depth at full width (None: all layers) and why it is cut. Windowed
# configs' dense caches hold at least the window (the ring's length).
FAMILIES: Dict[str, Dict[str, Any]] = {
    "olmoe-1b-7b": dict(
        batchers=("paged",), new=32, full_prompts=None,
        reduced_prompts=(7, 17, 30, 12), slots=8, reduced_slots=2),
    "recurrentgemma-2b": dict(
        batchers=("dense",), new=16,
        # the 2048-token prompt fills its rings: its KV stops growing
        full_prompts=(2048, 1024, 512, 300),
        reduced_prompts=(64, 40, 20, 9), slots=4, reduced_slots=2),
    "mamba2-130m": dict(
        batchers=("paged", "dense"), new=16,
        full_prompts=(512, 256, 100, 200),
        reduced_prompts=(64, 32, 12, 20), slots=4, reduced_slots=2),
    "internvl2-2b": dict(
        batchers=("batched",), new=32, full_prompts=(128,) * 4,
        reduced_prompts=(12, 12), slots=4, reduced_slots=2),
    "llama4-scout-17b-a16e": dict(
        batchers=("dense",), new=16, full_prompts=(512, 300, 128, 64),
        reduced_prompts=(64, 33, 9), slots=4, reduced_slots=2,
        layers=4, cut="48 layers are ~109 B parameters, ~218 GB in bf16, "
        "beyond one 80 GB card; 4 layers are one pattern repetition (3 "
        "chunked + 1 full), ~10.9 B parameters"),
}
PAGE_SIZE, CHUNK_STEPS = 16, 16
REDUCED_PAGE_SIZE, REDUCED_CHUNK_STEPS = 8, 4


def family_config(name: str, full: bool, reduced_layers: int = 0):
    """The family's config: full width (cut to the run's depth), or
    reduced to `reduced_layers` (0: the reduced default)."""
    run = FAMILIES[name]
    cfg = get_arch(name)
    if not full:
        return reduced(cfg, layers=reduced_layers or None)
    if run.get("layers"):
        cfg = dataclasses.replace(cfg, num_layers=run["layers"])
    return cfg


def prompts_of(cfg, name: str, full: bool, seed: int = 0) -> List[np.ndarray]:
    """The run's prompts: seeded random tokens at its lengths (olmoe at
    full width: 8 lengths drawn from 64-512)."""
    run = FAMILIES[name]
    rng = np.random.default_rng(seed)
    lengths = run["full_prompts"] if full else run["reduced_prompts"]
    if lengths is None:
        lengths = rng.integers(64, 513, run["slots"])
    return [rng.integers(0, cfg.vocab_size, int(n)) for n in lengths]


def prefix_embeds_of(cfg, batch: int, seed: int = 0) -> Optional[np.ndarray]:
    """Random float32 stand-ins for a frontend's embeddings (None for a
    config without a frontend)."""
    if cfg.frontend is None:
        return None
    rng = np.random.default_rng(seed + 1)
    return rng.standard_normal((batch, cfg.frontend.num_prefix_tokens,
                                cfg.d_model)).astype(np.float32)


def _layers(cfg, kinds) -> int:
    return sum(1 for k in cfg.layer_kinds() if k in kinds)


def serve_family(model, params, name: str, batcher: str,
                 prompts: List[np.ndarray], full: bool,
                 collect_logits: bool = False) -> Dict[str, Any]:
    """Serve `prompts` greedily through one batcher ("paged", "dense" or
    "batched") at the run's geometry. Returns {"engine", "outputs" (token
    lists by request), "logits" (per request, with `collect_logits`; not
    for the dense batcher), "wall_s", "tokens" (generated), "expected"
    (launches per kernel the run makes: layers x calls)}."""
    run = FAMILIES[name]
    cfg = model.cfg
    new = run["new"]
    slots = run["slots"] if full else run["reduced_slots"]
    n_full = _layers(cfg, ("full",))
    n_attn = _layers(cfg, ("full", "local", "chunked"))
    longest = max(len(p) for p in prompts)
    out: Dict[str, Any] = {}
    t0 = time.perf_counter()
    if batcher == "batched":
        embeds = prefix_embeds_of(cfg, len(prompts))
        n_pfx = 0 if embeds is None else embeds.shape[1]
        batch = {"tokens": np.stack(prompts)}
        if embeds is not None:
            batch["prefix_embeds"] = embeds
        eng = BatchedServer(model, params, ServeConfig(
            max_len=n_pfx + longest + new, max_new_tokens=new),
            collect_logits=collect_logits)
        res = eng.generate(batch)
        out["outputs"] = [list(map(int, r)) for r in res["tokens"]]
        if collect_logits:
            out["logits"] = list(res["logits"])
        out["expected"] = {"flash_attention": n_full,
                           "gqa_decode": n_attn * (new - 1),
                           "paged_gqa_decode": 0}
    else:
        if batcher == "paged":
            ps = PAGE_SIZE if full else REDUCED_PAGE_SIZE
            per_slot = -(-(longest + new) // ps)
            eng = PagedContinuousBatcher(
                model, params, num_slots=slots, page_size=ps,
                num_pages=slots * per_slot + 1, max_pages_per_slot=per_slot,
                chunk_steps=CHUNK_STEPS if full else REDUCED_CHUNK_STEPS,
                collect_logits=collect_logits)
        else:
            # a ring holds local_window rows only when the cache does
            max_len = max(longest + new, cfg.local_window)
            eng = ContinuousBatcher(model, params, num_slots=slots,
                                    max_len=max_len)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, tokens=p, max_new_tokens=new))
        done = sorted(eng.run(), key=lambda r: r.rid)
        out["outputs"] = [r.output for r in done]
        if collect_logits and batcher == "paged":
            out["logits"] = [np.stack(r.logits) for r in done]
        st = eng.stats
        if batcher == "paged":
            out["expected"] = {
                "flash_attention": n_full * st.prefills,
                "paged_gqa_decode": n_full * st.chunks * eng.chunk_steps,
                "gqa_decode": 0}
        else:
            out["expected"] = {"flash_attention": n_full * st.prefills,
                               "gqa_decode": n_attn * st.decode_steps,
                               "paged_gqa_decode": 0}
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    out["wall_s"] = time.perf_counter() - t0
    out["engine"] = eng
    out["tokens"] = sum(len(o) for o in out["outputs"])
    return out


def sweep_trace(engine, device):
    """The (C, B) sweep of a batcher's "kv" trace over its minimum
    capacity and the next two 32 MiB steps (None for an engine without a
    trace, or a trace with no events: mamba2's pages hold no KV)."""
    if not hasattr(engine, "occupancy_bundle"):
        return None
    bundle = engine.occupancy_bundle()
    tr = bundle.traces["kv"]
    if not tr.ev_times:
        return None
    m = min_capacity_mib(tr.peak_needed())
    return sweep(bundle, mem_name="kv", capacities_mib=[m, m + 32, m + 64],
                 banks=[1, 2, 4, 8, 16], prune=True, device=device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="full width, bf16 (default: reduced, float32)")
    ap.add_argument("--family", action="append", choices=sorted(FAMILIES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    dtype = torch.bfloat16 if args.full else torch.float32
    for name in args.family or FAMILIES:
        cfg = family_config(name, args.full)
        model = DecoderLM(cfg, compute_dtype=dtype, device=args.device)
        gen = torch.Generator(device=model.device).manual_seed(args.seed)
        params = init_params(cfg, gen, device=model.device, dtype=dtype)
        prompts = prompts_of(cfg, name, args.full, args.seed)
        for batcher in FAMILIES[name]["batchers"]:
            res = serve_family(model, params, name, batcher, prompts,
                               args.full)
            eng = res["engine"]
            line = (f"{cfg.name} [{'/'.join(sorted(set(cfg.layer_kinds())))}"
                    f", {cfg.num_layers} layers] {batcher}: "
                    f"{len(prompts)} requests, {res['tokens']} tokens in "
                    f"{res['wall_s']:.2f} s")
            if hasattr(eng, "occupancy_bundle"):
                tr = eng.occupancy_bundle().traces["kv"]
                line += f", trace peak {tr.peak_needed()} B"
            print(line)
            table = sweep_trace(eng, args.device)
            if table is not None:
                b = table.best()
                print(f"  Stage II: {len(table.rows)} rows, best "
                      f"{b.capacity_mib} MiB x {b.banks} banks, "
                      f"{b.result.e_total:.4g} J")
        del model, params
        if args.device != "cpu":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
