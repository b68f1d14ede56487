"""Capacity-factor token-choice MoE (GShard/Switch style), scatter-based;
port of the reference's `repro/models/moe.py` (olmoe, llama4-scout).

Tokens are scattered into a per-expert buffer (E, C, D) with one spill row
for the dropped ones, the experts run as batched matrix products, and the
outputs are gathered back, gated. Top-k routing with renormalised
probabilities, capacity dropping, and a Switch-style load-balancing
auxiliary loss, as the reference.

Every step is chosen to be deterministic on the card as on the CPU: the
top-k is a stable descending sort (ties go to the lower expert index, as
`jax.lax.top_k`), the ranking a stable argsort, the dispatch writes each
kept row once, and the combine sums each token's k rows in choice order
rather than by atomics."""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import gelu


def capacity(num_tokens: int, cfg) -> int:
    """Rows per expert for a call of `num_tokens` tokens: top_k / E of
    them times the capacity factor, rounded up to a multiple of 8 (at
    least 8)."""
    m = cfg.moe
    c = math.ceil(num_tokens * m.top_k / m.num_experts * m.capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


def _act(cfg):
    return F.silu if cfg.ffn_kind == "swiglu" else gelu


def route(cfg, router: torch.Tensor, xf: torch.Tensor):
    """Routing of T tokens xf (T, D): float32 softmax over the experts,
    top-k with ties to the lower index, renormalised. Returns (probs (T, E),
    top_p (T, k), top_e (T, k) int64)."""
    k = cfg.moe.top_k
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_e


def dispatch(cfg, top_e: torch.Tensor, C: int):
    """Rank each (token, choice) copy within its expert in token order (a
    stable argsort by expert id) and give it a buffer row: expert * C +
    rank when the rank is below the capacity C, else the spill row E * C.
    Returns (slot (T * k,) int64, keep (T * k,) bool)."""
    E = cfg.moe.num_experts
    eid = top_e.reshape(-1)
    N = eid.shape[0]
    order = torch.argsort(eid, stable=True)
    # per-expert counts (a bincount with a static length E, so that the
    # dry run's fake tensors can trace it)
    hist = torch.zeros(E, dtype=eid.dtype, device=eid.device).scatter_add_(
        0, eid, torch.ones_like(eid))
    starts = torch.cumsum(hist, 0) - hist
    rank_sorted = torch.arange(N, device=eid.device) - starts[eid[order]]
    pos = torch.empty_like(eid)
    pos[order] = rank_sorted
    keep = pos < C
    slot = torch.where(keep, eid * C + pos, torch.full_like(eid, E * C))
    return slot, keep


def apply_moe(cfg, p: dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss float32 scalar). Every token
    of the call competes for the capacity C = capacity(B * S)."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.num_experts, m.top_k
    T = B * S
    C = capacity(T, cfg)
    dt = x.dtype
    xf = x.reshape(T, D)

    probs, top_p, top_e = route(cfg, p["router"], xf)
    # Switch-style load-balance loss on the top-1 assignment
    f = F.one_hot(top_e[:, 0], E).float().mean(0)
    aux = E * (f * probs.mean(0)).sum() * m.aux_loss_weight

    slot, _ = dispatch(cfg, top_e, C)
    src = torch.arange(T, device=x.device).repeat_interleave(k)
    # kept slots are unique; dropped copies all land on the spill row,
    # which is cut off
    buf = torch.zeros((E * C + 1, D), dtype=dt, device=x.device)
    buf[slot] = xf[src]
    buf = buf[:E * C].reshape(E, C, D)

    act = _act(cfg)
    g = act(torch.bmm(buf, p["w_gate"].to(dt)))
    u = torch.bmm(buf, p["w_up"].to(dt))
    eo = torch.bmm(g * u, p["w_down"].to(dt))

    eo_flat = torch.cat([eo.reshape(E * C, D),
                         torch.zeros((1, D), dtype=dt, device=x.device)])
    y = (eo_flat[slot] * top_p.reshape(T * k).to(dt)[:, None]).reshape(
        T, k, D)
    # the reference's scatter-add of each token's k rows, in choice order
    out = y[:, 0]
    for j in range(1, k):
        out = out + y[:, j]

    if m.shared_expert:
        sp = p["shared"]
        sg = act(xf @ sp["w_gate"].to(dt))
        su = xf @ sp["w_up"].to(dt)
        out = out + (sg * su) @ sp["w_down"].to(dt)
    return out.reshape(B, S, D), aux
