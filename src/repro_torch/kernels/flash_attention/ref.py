"""Plain PyTorch version of the causal prefill attention kernel.

Same function as the reference's `flash_attention_ref` and jnp
`blocked_attention` (causal, no query offset), in the layout the model uses:
q (B, S, H, h), k/v (B, T, K, h) with H % K == 0; query head h reads KV head
h // (H // K). Full float32 softmax; output in q's dtype."""
from __future__ import annotations

import math

import torch

NEG_INF = -1.0e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    B, S, H, d = q.shape
    T, K = k.shape[1], k.shape[2]
    group = H // K
    qf = q.float() / math.sqrt(d)
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bshd,bthd->bhst", qf, kf)
    mask = (torch.arange(S, device=q.device)[:, None]
            >= torch.arange(T, device=q.device)[None, :])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, vf).to(q.dtype)
