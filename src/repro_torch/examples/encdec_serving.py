"""The encoder-decoder (seamless-m4t) served by `BatchedServer`, its KV
trace swept by Stage II.

A batch of frame embeddings (the stubbed audio frontend's output) and
prompts goes through `EncDecModel`: the encoder's self-attention and the
decoder's cross attention run kernel 2 without its causal mask, the
decoder's self-attention kernel 2 causally; every decode step attends its
dense self cache and the cached memory projections through kernel 7
(`gqa_decode`). A `KVLog` rides the server as its `meter` and keeps the
batch's decoder KV footprint events (admission, decode growth, release;
the reference's); `sweep_log` sweeps that trace over (C, B) through
kernels 3 and 4 (plain PyTorch on the CPU).

`RUNS` holds the run at full width and reduced; `expected_launches` what
one `generate` launches per kernel (layers x calls), which
`chip_smoke.py` holds against the counted launches.

Run on the card (full width, bf16, random weights):
    PYTHONPATH=src python -m repro_torch.examples.encdec_serving --full
Run on the CPU (reduced, float32):
    PYTHONPATH=src python -m repro_torch.examples.encdec_serving \
        --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core.explorer import min_capacity_mib, sweep
from repro_torch.models import EncDecModel
from repro_torch.params import init_params
from repro_torch.serve import BatchedServer, ServeConfig
from repro_torch.sim.trace import AccessStats, OccupancyTrace, TraceBundle

ARCH = "seamless-m4t-large-v2"
# batch, encoder frames, prompt tokens and new tokens per request
RUNS: Dict[bool, Dict[str, int]] = {
    True: dict(batch=4, frames=1024, prompt=32, new=32),
    False: dict(batch=3, frames=40, prompt=9, new=12),
}


class KVLog:
    """A `meter` for `BatchedServer` that keeps what it is given: the KV
    trace on the server's wall clock, and each event's (d_needed,
    d_obsolete, request, cause)."""

    def __init__(self):
        self.trace = OccupancyTrace("kv", 0)
        self.events = []

    def record(self, t: float, d_needed: int, d_obsolete: int = 0, *,
               rid=None, tenant=None, cause=None, weight_delta=None):
        self.trace.event(t, d_needed, d_obsolete)
        self.events.append((int(d_needed), int(d_obsolete), rid, cause))


def config(full: bool, layers: int = 2):
    """seamless-m4t at full width, or `reduced(..., layers)`."""
    cfg = get_arch(ARCH)
    return cfg if full else reduced(cfg, layers=layers)


def inputs(cfg, run: Dict[str, int], seed: int):
    """(frames (B, S_enc, D) float32, prompts (B, S) int32) from numpy's
    generator seeded `seed`."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal(
        (run["batch"], run["frames"], cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size,
                          (run["batch"], run["prompt"])).astype(np.int32)
    return frames, tokens


def expected_launches(cfg, new_tokens: int) -> Dict[str, int]:
    """Kernel launches of one `generate`: the prefill runs kernel 2 once
    per encoder layer and twice per decoder layer (causal self-attention,
    cross attention), each of the new_tokens - 1 decode steps kernel 7
    twice per decoder layer (self, cross)."""
    L = cfg.num_layers
    return {"flash_attention": cfg.encoder_layers + 2 * L,
            "gqa_decode": 2 * L * (new_tokens - 1)}


def serve(model, params, frames, tokens, new_tokens: int, *,
          collect_logits: bool = False) -> Dict[str, Any]:
    """One `BatchedServer.generate` of the frames and prompts with a
    `KVLog` as its meter. Returns generate's result plus "log" and
    "wall_s"."""
    log = KVLog()
    srv = BatchedServer(model, params, ServeConfig(
        max_len=tokens.shape[1] + new_tokens, max_new_tokens=new_tokens),
        collect_logits=collect_logits, meter=log)
    t0 = time.perf_counter()
    res = srv.generate({"frames": frames, "tokens": tokens})
    res["wall_s"] = time.perf_counter() - t0
    res["log"] = log
    return res


def log_bundle(log: KVLog) -> TraceBundle:
    """The log's KV trace as a Stage-II bundle ("kv"), its times moved to
    start at 0 (they are the server's wall clock)."""
    t = np.asarray(log.trace.ev_times, np.float64)
    t = t - t[0]
    tr = OccupancyTrace("kv", 0)
    tr.extend(t, log.trace.ev_dneeded, log.trace.ev_dobsolete)
    return TraceBundle(graph_name=f"{ARCH}-batched", total_time=float(t[-1]),
                       traces={"kv": tr}, access=AccessStats())


def sweep_log(log: KVLog, device):
    """The (C, B) sweep of the log's trace over its minimum capacity and
    the next two 32 MiB steps, pruned (kernel 4's bound, then kernel 3 on
    the survivors)."""
    bundle = log_bundle(log)
    m = min_capacity_mib(bundle.peak_needed())
    return sweep(bundle, mem_name="kv", capacities_mib=[m, m + 32, m + 64],
                 banks=[1, 2, 4, 8, 16], prune=True, device=device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="full width, bf16 (default: reduced, float32)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cfg, run = config(args.full), RUNS[args.full]
    dtype = torch.bfloat16 if args.full else torch.float32
    model = EncDecModel(cfg, compute_dtype=dtype, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=model.device, dtype=dtype)
    frames, tokens = inputs(cfg, run, args.seed)
    res = serve(model, params, frames, tokens, run["new"])
    st = res["stats"]
    print(f"{cfg.name} [{cfg.encoder_layers} + {cfg.num_layers} layers]: "
          f"{run['batch']} x ({run['frames']} frames, {run['prompt']} "
          f"tokens) -> {st.tokens_generated} tokens in {res['wall_s']:.2f} "
          f"s (prefill {st.prefill_s * 1e3:.1f} ms)")
    table = sweep_log(res["log"], model.device)
    best = table.best()
    print(f"  KV trace peak {log_bundle(res['log']).peak_needed()} B, "
          f"{len(table.rows)} (C, B) rows, best C {best.capacity_mib} MiB "
          f"B {best.banks}: {best.result.e_total:.6g} J")


if __name__ == "__main__":
    main()
