"""Attention pieces of the port (reference: `repro/models/attention.py`).

The attention itself runs in the hand-written kernels:
`kernels.flash_attention` for prefill, `kernels.paged_gqa_decode` and
`kernels.paged_gqa_verify` on paged caches, `kernels.gqa_decode` on the
dense decode cache. The Q/K/V/O projections are plain matrix products."""
from __future__ import annotations

import torch

from repro_torch.kernels.gqa_decode import gqa_decode


def project_qkv(cfg, p: dict, xq: torch.Tensor, xkv: torch.Tensor):
    """(B,S,D)->(B,S,H,h) and (B,T,D)->(B,T,K,h), with the QKV bias of
    configs that carry one (dsr1d-qwen)."""
    B, S, _ = xq.shape
    T = xkv.shape[1]
    dt = xq.dtype
    q = xq @ p["wq"].to(dt)
    k = xkv @ p["wk"].to(dt)
    v = xkv @ p["wv"].to(dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, h); caches: (B, T, K, h); lengths: (B,) int32, each
    sequence's valid prefix (a `decode_valid_mask("full", ...)` row count).
    -> (B, 1, H, h) in q's dtype.

    The reference computes this with a jnp einsum over the valid mask; the
    port runs the same function through `kernels.gqa_decode` (the CUDA
    kernel on the card, its plain version on the CPU), handing it the
    (B, K, T, h) view of the cache without a copy."""
    out = gqa_decode(q[:, 0], k_cache.transpose(1, 2),
                     v_cache.transpose(1, 2), lengths)
    return out[:, None]


def cache_write(cache_k: torch.Tensor, cache_v: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor, write_idx: int):
    """Write one K/V row per sequence at position `write_idx`, in place.

    cache_*: (B, T, K, h); k, v: (B, 1, K, h). As the reference's
    `jax.lax.dynamic_update_slice`, the index is clamped into [0, T - 1]:
    a write past the cache overwrites its last row."""
    idx = min(max(int(write_idx), 0), cache_k.shape[1] - 1)
    cache_k[:, idx] = k[:, 0].to(cache_k.dtype)
    cache_v[:, idx] = v[:, 0].to(cache_v.dtype)
    return cache_k, cache_v


def decode_valid_mask(kind: str, cache_len: int, pos: int,
                      device=None) -> torch.Tensor:
    """Which cache slots a query at absolute position `pos` may attend:
    (cache_len,) bool. kind "full" is a linear cache, slots [0, pos] valid
    (all of them once pos >= cache_len). The ring caches of "local" and
    "chunked" layers come with the other model families."""
    if kind != "full":
        raise NotImplementedError(
            f"{kind!r} attention is not ported yet; the port decodes "
            "full-attention caches only")
    return torch.arange(cache_len, device=device) <= pos
