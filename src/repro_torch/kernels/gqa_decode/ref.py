"""Plain PyTorch versions of dense-cache GQA decode attention.

`gqa_decode_ref` is the reference's `repro/kernels/gqa_decode/ref.py`: one
float32 masked softmax over the whole cache; the wrapper runs it on the
CPU. `gqa_decode_split_ref` repeats the split-context kernel's structure
(`csrc/decode_attention.cuh`, `decode_split_kernel` and
`decode_merge_kernel`): the same splits, partials and merge order, with
the sums inside a split taken in PyTorch's order. It is the yardstick the
kernel is held to: tests only."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1.0e30
# context rows per split block (csrc/decode_attention.cuh kSplitRows)
SPLIT_ROWS = 64


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


def gqa_decode_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, split_rows: int,
                         k_scale: torch.Tensor = None,
                         v_scale: torch.Tensor = None) -> torch.Tensor:
    """The split-context arithmetic, arguments as `gqa_decode_ref`. Split s
    covers cache rows [s * split_rows, (s + 1) * split_rows); the split
    count, ceil(T / split_rows), depends on T only. Rows past lengths[b]
    are zeros, as the kernel's copies leave them. Each split keeps a
    float32 partial (m, l, acc) of its valid rows; a split wholly past
    lengths[b] keeps m = -1e30, l = 0, acc = 0. The merge weighs split s by
    exp(m_s - max m) (0 where m_s <= -1e30 / 2) and sums in the fixed order
    0, 1, ..., then divides by the summed l clamped at 1e-30.

    Rows that carry scales (int8 codes in k, v with k_scale, v_scale of
    shape (B, K, T)) enter as the kernel's scaled loads do: a score is the
    dot product with the codes times the row's K scale, and acc sums the
    codes of row r weighted by p_r times its V scale (l sums p_r)."""
    B, H, d = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    ns = -(-T // split_rows)
    t = torch.arange(ns * split_rows, device=q.device).reshape(ns, split_rows)
    n = torch.clamp(lengths.to(q.device).long(), max=T)
    valid = (t[None] < n[:, None, None])[:, None, None]   # (B, 1, 1, ns, r)
    # rows past the sequence are zero-filled, not read, as the kernel's
    # copies are (a NaN there never meets p = 0)
    pad = (0, 0, 0, ns * split_rows - T)
    kf, vf = (torch.where(valid[:, :, 0, ..., None], F.pad(
        x.float(), pad).reshape(B, K, ns, split_rows, d), 0.0) for x in (k, v))
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    qs = q.float().reshape(B, K, G, d) * scale
    s = torch.einsum("bkgd,bknrd->bkgnr", qs, kf)
    if k_scale is not None:
        s = s * F.pad(k_scale.float(), pad[2:]).reshape(
            B, K, 1, ns, split_rows)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)                                        # (B, K, G, ns)
    p = torch.exp(s - m[..., None])
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
    l = p.sum(-1)
    if v_scale is not None:
        p = p * F.pad(v_scale.float(), pad[2:]).reshape(
            B, K, 1, ns, split_rows)
    acc = torch.einsum("bkgnr,bknrd->bkgnd", p, vf)
    top = m.amax(-1, keepdim=True)
    w = torch.exp(m - top)
    w = torch.where(m <= NEG_INF / 2, torch.zeros_like(w), w)
    den = torch.zeros_like(top[..., 0])
    out = torch.zeros_like(acc[..., 0, :])
    for i in range(ns):
        den = den + l[..., i] * w[..., i]
        out = out + acc[..., i, :] * w[..., i, None]
    out = out / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(B, H, d).to(q.dtype)
