"""Plain PyTorch version of paged GQA decode attention.

Same function as the reference's `paged_gqa_decode_ref`
(`repro/kernels/paged_gqa_decode/ref.py`): gather each slot's pages back into
a dense cache through its page-table row, then one float32 masked softmax.
Tokens of slot b live at pool[page_table[b, t // ps], :, t % ps] for
t < lengths[b]; rows past `lengths` (the tail of a partial last page and the
null-page slots) are masked out."""
from __future__ import annotations

import math

import torch


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """pool: (N, K, ps, d); page_table: (B, P) -> dense (B, K, P*ps, d)."""
    B, P = page_table.shape
    N, K, ps, d = pool.shape
    g = pool[page_table.long()]                    # (B, P, K, ps, d)
    return g.permute(0, 2, 1, 3, 4).reshape(B, K, P * ps, d)


def paged_gqa_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_table: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, d); k_pages, v_pages: (N, K, ps, d); page_table: (B, P);
    lengths: (B,) true context sizes (<= P*ps). Returns (B, H, d)."""
    B, H, d = q.shape
    K, ps = k_pages.shape[1], k_pages.shape[2]
    T = page_table.shape[1] * ps
    group = H // K
    k = gather_pages(k_pages, page_table).float()
    v = gather_pages(v_pages, page_table).float()
    qg = (q.float() / math.sqrt(d)).reshape(B, K, group, d)
    s = torch.einsum("bkgd,bktd->bkgt", qg, k)
    valid = (torch.arange(T, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, torch.zeros_like(p))
    out = torch.einsum("bkgt,bktd->bkgd", p, v)
    return out.reshape(B, H, d).to(q.dtype)
