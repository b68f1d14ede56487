"""Plain PyTorch version of dense-cache GQA decode attention (as the
reference's `repro/kernels/gqa_decode/ref.py`: one float32 masked softmax
over the whole cache)."""
from __future__ import annotations

import math

import torch


def gqa_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, d); k, v: (B, K, T, d) (any strides); lengths: (B,) valid
    rows per sequence (past T: all T). Returns (B, H, d) in q's dtype."""
    B, H, d = q.shape
    K, T = k.shape[1], k.shape[2]
    group = H // K
    qg = (q.float() / math.sqrt(d)).reshape(B, K, group, d)
    s = torch.einsum("bkgd,bktd->bkgt", qg, k.float())
    valid = (torch.arange(T, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, torch.zeros_like(p))
    out = torch.einsum("bkgt,bktd->bkgd", p, v.float())
    return out.reshape(B, H, d).to(q.dtype)
