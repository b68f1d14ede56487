"""Plain PyTorch versions of the prefill attention kernels.

`flash_attention_ref` is the same function as the reference's
`flash_attention_ref` and jnp `blocked_attention` (causal with its query
offset, or not), in the layout the model uses: q (B, S, H, h), k/v
(B, T, K, h) with H % K == 0; query head h reads KV head h // (H // K);
causal, query row s attends keys t <= q_offset + s, else all T keys. Full
float32 softmax; output in q's dtype. The wrapper runs it on the CPU.

`flash_attention_bf16_mirror_ref` repeats the arithmetic of the bf16
tensor-core kernel (`csrc/flash_attention.cu`, `flash_tc_kernel`), and is
the yardstick it is held to: tests only."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1.0e30
# keys per KV tile of the tensor-core kernel (csrc/flash_attention.cu kBK)
KV_TILE = 64
LOG2E = 1.4426950408889634
# Absolute slack beyond one bf16 step per element when the kernel is held
# to its mirror (and the mirror to JAX at head dim 64). The two sum the same
# float32 scores in different orders, so a rare p lands on the other side of
# a bf16 rounding boundary and moves its row by a little more than a step.
# A version that keeps P in float32 instead of rounding it to bf16 strays by
# 1.4e-3 to 2.8e-3 at the tests' and the smoke's shapes, so it fails.
MIRROR_ATOL = 2.0 ** -10


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_offset: int = 0,
                        causal: bool = True) -> torch.Tensor:
    if q_offset and not causal:
        raise ValueError("q_offset applies to causal attention only")
    B, S, H, d = q.shape
    T, K = k.shape[1], k.shape[2]
    group = H // K
    qf = q.float() / math.sqrt(d)
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bshd,bthd->bhst", qf, kf)
    mask = (torch.arange(S, device=q.device)[:, None] + q_offset
            >= torch.arange(T, device=q.device)[None, :])
    if causal:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, vf).to(q.dtype)


def flash_attention_bf16_mirror_ref(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor,
                                    q_offset: int = 0,
                                    causal: bool = True) -> torch.Tensor:
    """The tensor-core kernel's arithmetic: KV tiles of 64 keys walked from
    key 0 upward, query row s at position q_offset + s (`causal=False`: all
    T keys); float32 scores of
    the bf16 operands, scaled by log2(e) / sqrt(h) in float32; a masked
    score is -1e30 and gives p = 0; an online softmax in base 2 with
    float32 m, l and accumulators; P rounded to bf16 for P·V; the
    denominator clamped at 1e-30. Products of bf16 values are exact in
    float64, so the tile products are summed there and rounded once: a row
    does not depend on the prompt's length, the query offset or the matrix
    shapes. Inputs are bf16; returns (B, S, H, h) in bf16."""
    B, S, H, d = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    c = torch.tensor(LOG2E / math.sqrt(d), dtype=torch.float32)
    nt = -(-T // KV_TILE)
    pad = (0, 0, 0, 0, 0, nt * KV_TILE - T)
    kd, vd = F.pad(k.double(), pad), F.pad(v.double(), pad)
    qd = q.double().reshape(B, S, K, G, d)
    rows = torch.arange(S, device=q.device)[:, None] + q_offset
    m = torch.full((B, S, K, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, S, K, G, d), dtype=torch.float32, device=q.device)
    for j in range(nt):
        ks = slice(j * KV_TILE, (j + 1) * KV_TILE)
        s = torch.einsum("bskgd,btkd->bskgt", qd, kd[:, ks]).float() * c
        keys = torch.arange(ks.start, ks.stop, device=q.device)[None, :]
        valid = (((keys <= rows) | (not causal))
                 & (keys < T))[None, :, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - m_new[..., None])
        p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bskgt,btkd->bskgd", p.to(torch.bfloat16).double(),
                          vd[:, ks]).float()
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, S, H, d).to(q.dtype)


def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at each element of `x` (0 where x is
    0), as a float32 tensor of x's shape."""
    a = x.float().abs()
    e = torch.frexp(a).exponent
    return torch.where(a > 0, torch.ldexp(torch.ones_like(a), e - 8),
                       torch.zeros_like(a))


def bf16_excess(x: torch.Tensor, mirror: torch.Tensor) -> float:
    """How far `x` strays from `mirror` beyond one bf16 step of the mirror,
    element by element: max |x - mirror| - bf16_step(mirror). The
    tensor-core kernel is held to its mirror by bf16_excess <= MIRROR_ATOL."""
    if not x.numel():
        return 0.0
    diff = (x.float() - mirror.float()).abs()
    return float((diff - bf16_step(mirror)).max())
