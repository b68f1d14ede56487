"""Attention projections of the port (reference: `repro/models/attention.py`).

The attention itself runs in the hand-written kernels:
`kernels.flash_attention` for prefill, `kernels.paged_gqa_decode` for paged
decode. Only the Q/K/V/O projections are plain matrix products."""
from __future__ import annotations

import torch


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
