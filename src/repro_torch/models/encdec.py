"""Encoder-decoder transformer of the port (seamless-m4t backbone); port of
the reference's `repro/models/encdec.py`. The audio frontend is a stub: the
encoder consumes precomputed frame embeddings (B, S_enc, D).

    encode(params, frames)                   — the encoder over the frames
    loss(params, batch)                      — training loss
    init_cache(batch, cache_len, mem_len)    — decoder + cross caches
    prefill(params, batch, cache_len)        — encode, fill both caches
    decode_step(params, cache, tokens)       — one token

Attention runs in the hand-written kernels where the reference runs jnp:
the encoder's self-attention and the decoder's cross attention over the
memory through kernel 2 without its causal mask (`flash_attention(...,
causal=False)`), the decoder's self-attention through kernel 2 causally;
at decode, self-attention over the dense cache and cross attention over
the cached memory projections through kernel 7 (`gqa_decode`), the latter
with every row's length `mem_len` (the reference's all-true mask). The
loss runs `blocked_attention`, the plain differentiable version of kernel
2, in all three places instead (the reference's loss runs jnp attention;
the port has no backward kernel yet). Parameters keep the reference's tree
(`encdec_template`, from `repro_torch.params`).
Unlike the reference's immutable arrays, `decode_step` writes its K/V row
into the cache it is given, in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.device import require_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.attention import (blocked_attention, cache_write,
                                          cross_attention, decode_attention,
                                          decode_valid_mask, project_qkv)
from repro_torch.models.common import (apply_norm, checkpointed,
                                       cross_entropy, embed_tokens,
                                       lm_logits)
from repro_torch.models.ffn import apply_ffn
from repro_torch.models.transformer import layer
from repro_torch.params import (  # noqa: F401
    dec_block_template, enc_block_template, encdec_template)


def _serve_attention(q, k, v, causal: bool):
    """Kernel 2 (serving): causal, or `cross_attention` without the mask."""
    return flash_attention(q, k, v) if causal else cross_attention(q, k, v)


def _loss_attention(q, k, v, causal: bool):
    """The plain differentiable attention (the loss)."""
    return blocked_attention(q, k, v, causal=causal)


@dataclass
class EncDecModel:
    """Encoder-decoder of an `is_encdec` config, computing in
    `compute_dtype` on `device` (the card unless the caller asks for the
    CPU). With `remat` other than "none" the loss checkpoints each encoder
    and each decoder block, as the reference's does (`jax.checkpoint`
    without a policy, so "dots" acts as "full" here too)."""
    cfg: Any
    compute_dtype: torch.dtype = torch.bfloat16
    device: Any = "cuda"
    remat: str = "full"

    def __post_init__(self):
        if not self.cfg.is_encdec:
            raise ValueError(f"{self.cfg.name} is decoder-only: use "
                             "DecoderLM")
        self.device = require_device(self.device)

    def _tokens(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).long()

    # ----------------------------------------------------------- encoder
    def encode(self, params: dict, frames, attention=_serve_attention,
               remat: str = "none") -> torch.Tensor:
        """frames (B, S, D) -> the encoder memory (B, S, D): learned
        positions (clipped to the table), then every encoder block with
        non-causal attention, then the encoder's norm. Serving runs kernel
        2; the loss passes the plain version and its `remat`."""
        cfg = self.cfg
        dt = self.compute_dtype
        frames = torch.as_tensor(frames, device=self.device)
        B, S, _ = frames.shape
        table = params["enc_pos"].shape[0]
        pos = torch.arange(S, device=self.device).clamp(0, table - 1)
        x = frames.to(dt) + params["enc_pos"].to(dt)[pos]

        def block(x, p):
            y = apply_norm(cfg, p["norm1"], x)
            q, k, v = project_qkv(cfg, p["attn"], y, y)
            o = attention(q, k, v, False)
            x = x + o.reshape(B, S, cfg.q_dim) @ p["attn"]["wo"].to(dt)
            return x + apply_ffn(cfg, p["ffn"],
                                 apply_norm(cfg, p["norm2"], x))

        block = checkpointed("none" if remat == "none" else "full", block)
        for i in range(cfg.encoder_layers):
            x = block(x, layer(params["encoder"], i))
        return apply_norm(cfg, params["enc_norm"], x)

    # ----------------------------------------------------------- decoder
    def _dec_block(self, p: dict, x: torch.Tensor, memory: torch.Tensor,
                   attention=_serve_attention):
        """Causal self-attention, cross attention over `memory`, FFN.
        Returns (x_out, (k, v, kc, vc)): the self and cross K/V rows."""
        cfg = self.cfg
        dt = self.compute_dtype
        B, S, _ = x.shape
        y = apply_norm(cfg, p["norm1"], x)
        q, k, v = project_qkv(cfg, p["self_attn"], y, y)
        o = attention(q, k, v, True)
        x = x + o.reshape(B, S, cfg.q_dim) @ p["self_attn"]["wo"].to(dt)
        y = apply_norm(cfg, p["norm_c"], x)
        qc, kc, vc = project_qkv(cfg, p["cross_attn"], y, memory)
        oc = attention(qc, kc, vc, False)
        x = x + oc.reshape(B, S, cfg.q_dim) @ p["cross_attn"]["wo"].to(dt)
        x = x + apply_ffn(cfg, p["ffn"], apply_norm(cfg, p["norm2"], x))
        return x, (k, v, kc, vc)

    def _decode_inputs(self, params: dict, batch: dict,
                       attention=_serve_attention, remat: str = "none"):
        memory = self.encode(params, batch["frames"], attention, remat)
        tokens = self._tokens(batch["tokens"])
        B, S = tokens.shape
        positions = torch.arange(S, device=self.device)[None].expand(B, S)
        x = embed_tokens(self.cfg, params["embed"], tokens, positions,
                         self.compute_dtype)
        return memory, tokens, x

    # -------------------------------------------------------------- loss
    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token cross entropy of the decoder over
        batch["tokens"] (B, S) given batch["frames"]; labels default to
        the tokens. Attention runs `blocked_attention` (module
        docstring); each block is checkpointed unless `remat` is
        "none"."""
        cfg = self.cfg
        memory, tokens, x = self._decode_inputs(params, batch,
                                                _loss_attention, self.remat)

        def block(x, p, memory):
            return self._dec_block(p, x, memory, _loss_attention)[0]

        block = checkpointed("none" if self.remat == "none" else "full",
                             block)
        for i in range(cfg.num_layers):
            x = block(x, layer(params["decoder"], i), memory)
        x = apply_norm(cfg, params["final_norm"], x)
        logits = lm_logits(cfg, params["embed"], x[:, :-1, :])
        labels = self._tokens(batch.get("labels", batch["tokens"]))[:, 1:]
        return cross_entropy(logits, labels)

    # ------------------------------------------------------------ prefill
    def init_cache(self, batch: int, cache_len: int,
                   mem_len: int) -> Dict[str, Any]:
        """Self-attention K/V (L, batch, cache_len, K, h), cross K/V
        (L, batch, mem_len, K, h), all zeros, and the position 0."""
        cfg = self.cfg
        L = cfg.num_layers
        kw = dict(dtype=self.compute_dtype, device=self.device)
        shape = (L, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
        cshape = (L, batch, mem_len, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw),
                "ck": torch.zeros(cshape, **kw),
                "cv": torch.zeros(cshape, **kw), "pos": 0}

    def prefill(self, params: dict, batch: dict, cache_len: int):
        """batch: {"frames": (B, S_enc, D), "tokens": (B, S)}. Runs the
        encoder once, the decoder over the prompt, and returns
        (last-position logits (B, 1, V), the cache: the prompt's first
        min(S, cache_len) self K/V rows, the memory's cross K/V, "pos" S)."""
        cfg = self.cfg
        memory, tokens, x = self._decode_inputs(params, batch)
        B, S = tokens.shape
        cache = self.init_cache(B, cache_len, memory.shape[1])
        n = min(S, cache_len)
        for i in range(cfg.num_layers):
            x, (k, v, kc, vc) = self._dec_block(layer(params["decoder"], i),
                                                x, memory)
            cache["k"][i, :, :n] = k[:, :n].to(cache["k"].dtype)
            cache["v"][i, :, :n] = v[:, :n].to(cache["v"].dtype)
            cache["ck"][i] = kc.to(cache["ck"].dtype)
            cache["cv"][i] = vc.to(cache["cv"].dtype)
        cache["pos"] = S
        x = apply_norm(cfg, params["final_norm"], x)
        logits = lm_logits(cfg, params["embed"], x[:, -1:, :])
        return logits, cache

    # -------------------------------------------------------- decode step
    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """tokens: (B, 1). Returns (logits (B, 1, V), cache), the cache
        updated in place: each layer writes its self K/V row at `pos`
        (clamped to the cache's last row, as the reference's
        `dynamic_update_slice`) and attends the valid rows, then attends
        all of the memory; `pos` advances by one."""
        cfg = self.cfg
        dt = self.compute_dtype
        pos = int(cache["pos"])
        B = tokens.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.long,
                               device=self.device)
        x = embed_tokens(cfg, params["embed"], self._tokens(tokens),
                         positions, dt)
        T = cache["k"].shape[2]
        mem_len = cache["ck"].shape[2]
        self_len = decode_valid_mask("full", T, pos, device=self.device).sum(
            dtype=torch.int32).expand(B)
        mem_lens = torch.full((B,), mem_len, dtype=torch.int32,
                              device=self.device)
        for i in range(cfg.num_layers):
            p = layer(params["decoder"], i)
            y = apply_norm(cfg, p["norm1"], x)
            q, k, v = project_qkv(cfg, p["self_attn"], y, y)
            nk, nv = cache_write(cache["k"][i], cache["v"][i], k, v, pos)
            o = decode_attention(q, nk, nv, self_len)
            x = x + o.reshape(B, 1, cfg.q_dim) @ p["self_attn"]["wo"].to(dt)
            y = apply_norm(cfg, p["norm_c"], x)
            qc = (y @ p["cross_attn"]["wq"].to(dt)).reshape(
                B, 1, cfg.num_heads, cfg.head_dim)
            oc = decode_attention(qc, cache["ck"][i], cache["cv"][i],
                                  mem_lens)
            x = x + oc.reshape(B, 1, cfg.q_dim) @ p["cross_attn"]["wo"].to(dt)
            x = x + apply_ffn(cfg, p["ffn"], apply_norm(cfg, p["norm2"], x))
        cache["pos"] = pos + 1
        x = apply_norm(cfg, params["final_norm"], x)
        return lm_logits(cfg, params["embed"], x), cache
