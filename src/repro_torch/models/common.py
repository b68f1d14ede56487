"""Shared model building blocks of the port: norms, RoPE, embeddings and the
LM head (port of the reference's `repro/models/common.py`).

Parameters are plain dictionaries of tensors with the reference's keys and
shapes (`repro_torch.params`). Norms and RoPE compute in float32 and return
the input dtype, as the reference does."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm; `scale` stores (gain - 1), as the reference initialises it."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def apply_norm(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                 # (d/2,)
    ang = positions[..., :, None].float() * freqs                # (..., S, d/2)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_tokens(cfg, p: dict, tokens: torch.Tensor, positions: torch.Tensor,
                 dtype) -> torch.Tensor:
    """Token embedding, plus learned positions (clipped to the table) for
    `pos_emb == "learned"` (gpt2-xl)."""
    x = p["tok"].to(dtype)[tokens]
    if cfg.pos_emb == "learned":
        table = p["pos"].shape[0]
        x = x + p["pos"].to(dtype)[positions.clamp(0, table - 1)]
    return x


def lm_logits(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied (or separate) LM head; the padded tail of the vocabulary gets
    -1e9 so it never wins an argmax."""
    if cfg.tie_embeddings:
        logits = x @ p["tok"].to(x.dtype).T
    else:
        logits = x @ p["head"].to(x.dtype)
    if cfg.padded_vocab != cfg.vocab_size:
        mask = torch.zeros(cfg.padded_vocab, dtype=logits.dtype,
                           device=logits.device)
        mask[cfg.vocab_size:] = -1e9
        logits = logits + mask
    return logits


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")
