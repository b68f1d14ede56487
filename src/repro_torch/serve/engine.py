"""Batched serving engine of the port: prefill a batch of prompts, then
decode with a static dense KV cache (port of the reference's
`repro/serve/engine.py`).

The cache is preallocated to `max_len`. Decoding is a Python loop of device
steps (`DecoderLM.decode_step` or `EncDecModel.decode_step`, attending
through `kernels.gqa_decode`) with no host sync inside it: the emitted
tokens stay on the device until the loop ends. Sampling at temperature > 0
draws from a `torch.Generator` seeded from `ServeConfig.seed`; it does not
give JAX's draws, so the port matches the reference's tokens at temperature
0 only. With a `telemetry` registry each call records wall-clock "prefill"
and "decode" spans and the `serve.engine.*` counters; with a `meter` it
meters the batch's dense KV footprint as a wall-clock square wave, as the
reference does.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.obs.telemetry import noop_registry


@dataclass
class ServeConfig:
    max_len: int = 256
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 => greedy
    seed: int = 0


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_generated: int = 0
    # serving SLOs of the lockstep batch: every sequence sees its first
    # token at prefill end and one token per decode step after that
    ttft_s: float = 0.0
    tbt_s: float = 0.0

    @property
    def decode_tokens_per_s(self) -> float:
        return self.tokens_generated / self.decode_s if self.decode_s else 0.0


def _sample(temperature: float, logits: torch.Tensor,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Next token (B, 1) from the last position's logits: argmax at
    temperature 0 (the first maximal index, as jnp.argmax), else a draw
    from softmax(logits / temperature) with `gen`."""
    logits = logits[:, -1, :]
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)[:, None]
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)


def _generate_loop(model, temperature: float, collect_logits: bool,
                   steps: int, params, cache, tok, gen):
    """`steps` greedy/sampled decode steps, each on the device. Returns the
    emitted tokens (steps, B) and, with `collect_logits`, each step's
    last-position logits (steps, B, V), else None; `cache` is updated in
    place."""
    toks, step_logits = [], []
    for _ in range(steps):
        logits, cache = model.decode_step(params, cache, tok)
        tok = _sample(temperature, logits, gen)
        toks.append(tok[:, 0])
        if collect_logits:
            step_logits.append(logits[:, -1, :].float())
    return (torch.stack(toks),
            torch.stack(step_logits) if collect_logits else None)


class BatchedServer:
    def __init__(self, model, params, cfg: ServeConfig,
                 collect_logits: bool = False, telemetry=None, meter=None):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.collect_logits = collect_logits
        # wall-clock spans (this engine has no logical sim clock); claim the
        # registry's clock anyway so mixing this engine and a batcher on one
        # registry fails loudly instead of mixing time bases
        self.tel = telemetry if telemetry is not None else noop_registry()
        if telemetry is not None:
            telemetry.bind_clock(time.perf_counter, owner=self)
        # optional BankEnergyMeter: this engine has no page ledger, so each
        # generate() meters as a wall-clock square wave: the batch's dense
        # KV footprint admitted at prefill end, grown over decode, freed at
        # the end of the call
        self.meter = meter
        self._gen_seq = 0

    def generate(self, batch: Dict[str, Any],
                 max_new_tokens: Optional[int] = None) -> Dict[str, Any]:
        """batch: {"tokens": (B, S_prompt)} [+ "prefix_embeds" (B, n_pfx, D)
        for a config with a frontend, or "frames" (B, S_enc, D) for an
        encoder-decoder], passed whole to the prefill as the reference
        passes it. Returns {"tokens": (B, S_new)
        int64 numpy, "stats": ServeStats}; with `collect_logits` also
        "logits" (B, S_new, V) float32, the last-position logits that
        produced each emitted token (prefill step included)."""
        n_new = max_new_tokens or self.cfg.max_new_tokens
        dev = self.model.device
        gen = None
        if self.cfg.temperature > 0.0:
            gen = torch.Generator(device=dev).manual_seed(self.cfg.seed)
        tokens = torch.as_tensor(np.asarray(batch["tokens"]),
                                 dtype=torch.long, device=dev)
        inputs = dict(batch, tokens=tokens)
        stats = ServeStats()

        t0 = time.perf_counter()
        with self.tel.span("prefill", tokens=int(tokens.shape[1])):
            logits, cache = self.model.prefill(self.params, inputs,
                                               self.cfg.max_len)
            _sync(dev)
        stats.prefill_s = time.perf_counter() - t0

        rid = None
        kv0 = 0
        mcfg = getattr(self.model, "cfg", None)
        if self.meter is not None and mcfg is not None:
            from repro_torch.serve.scheduler import kv_bytes_at
            B, S = tokens.shape
            rid = f"gen{self._gen_seq}"
            self._gen_seq += 1
            kv0 = B * kv_bytes_at(mcfg, int(S), 2)
            self.meter.record(time.perf_counter(), kv0, 0, rid=rid,
                              cause="admission")

        tok = _sample(self.cfg.temperature, logits, gen)
        first = tok.cpu().numpy()
        first_logits = (logits[:, -1, :].float().cpu().numpy()
                        if self.collect_logits else None)
        stats.ttft_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        step_logits = None
        if n_new > 1:
            with self.tel.span("decode", steps=n_new - 1):
                toks, step_logits = _generate_loop(
                    self.model, self.cfg.temperature, self.collect_logits,
                    n_new - 1, self.params, cache, tok, gen)
                rest = toks.T.cpu().numpy()                 # (B, steps)
                if step_logits is not None:
                    step_logits = step_logits.cpu().numpy()  # (steps, B, V)
        else:
            rest = np.zeros((first.shape[0], 0), first.dtype)
        stats.decode_s = time.perf_counter() - t0
        stats.tokens_generated = n_new * first.shape[0]
        stats.tbt_s = stats.decode_s / (n_new - 1) if n_new > 1 else 0.0
        if rid is not None:
            from repro_torch.serve.scheduler import kv_bytes_at
            B, S = tokens.shape
            t_end = time.perf_counter()
            grown = B * kv_bytes_at(mcfg, int(S) + n_new, 2) - kv0
            if grown:
                self.meter.record(t_end, grown, 0, rid=rid,
                                  cause="decode_growth")
            self.meter.record(t_end, -(kv0 + grown), 0, rid=rid)
        self.tel.counter("serve.engine.generate_calls").inc()
        self.tel.counter("serve.engine.tokens_generated").inc(
            stats.tokens_generated)
        out = {"tokens": np.concatenate([first, rest], axis=1),
               "stats": stats}
        if self.collect_logits:
            parts = [first_logits[:, None]]
            if step_logits is not None:
                parts.append(step_logits.transpose(1, 0, 2))
            out["logits"] = np.concatenate(parts, axis=1)   # (B, n_new, V)
        return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
