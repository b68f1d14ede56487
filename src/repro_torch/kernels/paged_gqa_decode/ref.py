"""Plain PyTorch versions of paged GQA decode attention.

Same functions as the reference's `repro/kernels/paged_gqa_decode/ref.py`:
gather each slot's pages back into a dense cache through its page-table row,
then one float32 masked softmax. Tokens of slot b live at
pool[page_table[b, t // ps], :, t % ps] for t < lengths[b]; rows past
`lengths` (the tail of a partial last page and the null-page slots) are
masked out. Pools may hold any float dtype or fp8 E4M3 codes (uint8); int8
pools with per-row float32 scales go through the `*_quant_*` versions.
`paged_gqa_decode_split_ref` and `paged_gqa_decode_quant_split_ref` repeat
the kernels' split-context arithmetic (`csrc/decode_attention.cuh`) and are
the yardsticks they are held to: tests only."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.gqa_decode.ref import (SPLIT_ROWS,
                                                gqa_decode_split_ref)
from repro_torch.kernels.quant import from_fp8, is_fp8_pool


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """pool: (N, K, ps, d); page_table: (B, P) -> dense (B, K, P*ps, d)."""
    B, P = page_table.shape
    N, K, ps, d = pool.shape
    g = pool[page_table.long()]                    # (B, P, K, ps, d)
    return g.permute(0, 2, 1, 3, 4).reshape(B, K, P * ps, d)


def _gather_pool_f32(pool: torch.Tensor,
                     page_table: torch.Tensor) -> torch.Tensor:
    """`gather_pages` into float32; fp8 code pools decode by table first."""
    if is_fp8_pool(pool.dtype):
        return gather_pages(from_fp8(pool), page_table)
    return gather_pages(pool, page_table).float()


def gather_page_scales(scales: torch.Tensor,
                       page_table: torch.Tensor) -> torch.Tensor:
    """scales: (N, K, ps); page_table: (B, P) -> dense (B, K, P*ps)."""
    B, P = page_table.shape
    N, K, ps = scales.shape
    g = scales[page_table.long()]                  # (B, P, K, ps)
    return g.permute(0, 2, 1, 3).reshape(B, K, P * ps)


def paged_gqa_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_table: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, d); k_pages, v_pages: (N, K, ps, d); page_table: (B, P);
    lengths: (B,) true context sizes (<= P*ps). Returns (B, H, d)."""
    B, H, d = q.shape
    K, ps = k_pages.shape[1], k_pages.shape[2]
    T = page_table.shape[1] * ps
    group = H // K
    k = _gather_pool_f32(k_pages, page_table)
    v = _gather_pool_f32(v_pages, page_table)
    qg = (q.float() / math.sqrt(d)).reshape(B, K, group, d)
    s = torch.einsum("bkgd,bktd->bkgt", qg, k)
    valid = (torch.arange(T, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, torch.zeros_like(p))
    out = torch.einsum("bkgt,bktd->bkgd", p, v)
    return out.reshape(B, H, d).to(q.dtype)


def paged_gqa_decode_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               page_table: torch.Tensor,
                               lengths: torch.Tensor,
                               split_rows: int = SPLIT_ROWS) -> torch.Tensor:
    """The float and fp8 pools' kernel arithmetic, arguments as
    `paged_gqa_decode_ref`: each slot's pages gathered into (B, K, P*ps, d)
    float32 rows (fp8 codes decoded by table), then `gqa_decode_split_ref`
    over them. Split s covers table rows [s * split_rows, (s + 1) *
    split_rows), and the split count, ceil(P * ps / split_rows), depends on
    the table's width only; the splits merge in the fixed order 0, 1, ..."""
    k = _gather_pool_f32(k_pages, page_table)
    v = _gather_pool_f32(v_pages, page_table)
    return gqa_decode_split_ref(q, k, v, lengths, split_rows)


def paged_gqa_decode_quant_mirror_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                      v_pages: torch.Tensor,
                                      k_scale: torch.Tensor,
                                      v_scale: torch.Tensor,
                                      page_table: torch.Tensor,
                                      lengths: torch.Tensor) -> torch.Tensor:
    """int8 pools (N, K, ps, d) with per-row float32 scales (N, K, ps),
    computed page by page as the reference kernel does: each page's rows
    are dequantized (code x scale in float32), then one split-K online
    softmax update. Table slots at or past `lengths` are exact no-ops
    (corr == 1, p == 0)."""
    B, H, d = q.shape
    N, K, ps, _ = k_pages.shape
    P = page_table.shape[1]
    group = H // K
    qg = (q.float() * (1.0 / math.sqrt(d))).reshape(B, K, group, d)
    lens = lengths.to(q.device).long()
    m = torch.full((B, K, group), -1.0e30, device=q.device)
    l = torch.zeros((B, K, group), device=q.device)
    acc = torch.zeros((B, K, group, d), device=q.device)
    for it in range(P):
        pid = page_table[:, it].long()
        k = k_pages[pid].float() * k_scale[pid][..., None]
        v = v_pages[pid].float() * v_scale[pid][..., None]
        s = torch.einsum("bkgd,bkpd->bkgp", qg, k)
        tpos = it * ps + torch.arange(ps, device=q.device)
        s = torch.where(tpos[None, None, None, :] < lens[:, None, None, None],
                        s, torch.full_like(s, -1.0e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(s <= -1.0e30 / 2, torch.zeros_like(p), p)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgp,bkpd->bkgd", p, v)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, d).to(q.dtype)


def paged_gqa_decode_quant_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, k_scale: torch.Tensor,
                               v_scale: torch.Tensor,
                               page_table: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """Vectorised int8-pool version, the one the CPU path runs: gathers
    pages and scales densely and runs the single masked softmax of
    `paged_gqa_decode_ref`, with the per-row scales folded into the scores
    (K scale) and the softmax weights (V scale)."""
    B, H, d = q.shape
    k = gather_pages(k_pages, page_table).float()
    v = gather_pages(v_pages, page_table).float()
    ks = gather_page_scales(k_scale, page_table)              # (B, K, T)
    vs = gather_page_scales(v_scale, page_table)
    K, T = k.shape[1], k.shape[2]
    group = H // K
    qg = (q.float() / math.sqrt(d)).reshape(B, K, group, d)
    s = torch.einsum("bkgd,bktd->bkgt", qg, k) * ks[:, :, None, :]
    valid = (torch.arange(T, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, torch.zeros_like(p))
    out = torch.einsum("bkgt,bktd->bkgd", p * vs[:, :, None, :], v)
    return out.reshape(B, H, d).to(q.dtype)


def paged_gqa_decode_quant_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                     v_pages: torch.Tensor,
                                     k_scale: torch.Tensor,
                                     v_scale: torch.Tensor,
                                     page_table: torch.Tensor,
                                     lengths: torch.Tensor,
                                     split_rows: int = SPLIT_ROWS
                                     ) -> torch.Tensor:
    """The int8 kernel's split-context arithmetic, arguments as
    `paged_gqa_decode_quant_ref`: each slot's pages and scales gathered
    into (B, K, P*ps) rows, then `gqa_decode_split_ref` over them. Split s
    covers table rows [s * split_rows, (s + 1) * split_rows), and the split
    count, ceil(P * ps / split_rows), depends on the table's width only. A
    score is (q / sqrt(d)) . codes times the row's K scale; a split's
    accumulator sums the V codes weighted by p times the row's V scale; the
    splits merge in the fixed order 0, 1, ..."""
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    ks = gather_page_scales(k_scale, page_table)
    vs = gather_page_scales(v_scale, page_table)
    return gqa_decode_split_ref(q, k, v, lengths, split_rows, ks, vs)
