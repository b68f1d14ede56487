"""RecurrentGemma / Griffin recurrent block: causal conv + RG-LRU gated
linear recurrence; port of the reference's `repro/models/rglru.py`.

RG-LRU (Griffin, arXiv:2402.19427):
    r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full-sequence path runs the recurrence as a log-depth scan (the
reference's `jax.lax.associative_scan` computes the same prefix products
in another order); decode is one step of it."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import require_device
from repro_torch.models.common import gelu

_C = 8.0


def _conv_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, C), w (cw, C)."""
    cw = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + xp[:, i:i + S, :] * w[i]
    return out


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t with h_{-1} = 0 along axis 1, in log2(S)
    doubling steps (Hillis-Steele): after the step of offset o, element t
    holds the composition of elements t - 2o + 1 .. t."""
    S = a.shape[1]
    off = 1
    while off < S:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        b = torch.cat([b[:, :off], a[:, off:] * b_prev + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a_prev], 1)
        off *= 2
    return b


def rglru_scan(x: torch.Tensor, a_log: torch.Tensor,
               init_h: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The linear recurrence h_t = a_t h_{t-1} + b_t.

    x: gated inputs b_t (B, S, w) float32; a_log: log a_t (B, S, w) float32
    (<= 0). Returns (h (B, S, w), final h (B, w))."""
    a = torch.exp(a_log)
    b = x
    if init_h is not None:
        # fold the carried state into the first step
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * init_h
    h = linear_scan(a, b)
    return h, h[:, -1, :]


def _gates(p: dict, u: torch.Tensor):
    """From the conv output u: (a_log, gated input) in float32."""
    uf = u.float()
    r = torch.sigmoid(uf @ p["w_a"].float())
    i = torch.sigmoid(uf @ p["w_i"].float())
    a_log = -_C * F.softplus(p["lam"].float()) * r
    gated = torch.sqrt((1.0 - torch.exp(2.0 * a_log)).clamp_min(1e-9)) * (
        i * uf)
    return a_log, gated


def rglru_prefill(cfg, p: dict, x: torch.Tensor):
    """Full-sequence block that also returns its final state (the
    reference's `transformer._rglru_prefill`). x: (B, S, D) -> (out
    (B, S, D), {"h": (B, w) float32, "conv": the last conv_width - 1 rows
    of the conv input (B, cw - 1, w)})."""
    dt = x.dtype
    br = gelu(x @ p["w_branch"].to(dt))
    u_lin = x @ p["w_rec"].to(dt)
    u = _conv_causal(u_lin, p["conv"].to(dt))
    a_log, gated = _gates(p, u)
    h, h_last = rglru_scan(gated, a_log)
    out = (h.to(dt) * br) @ p["wo"].to(dt)
    cw = cfg.rglru.conv_width
    return out, {"h": h_last, "conv": u_lin[:, -(cw - 1):, :]}


def apply_rglru(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Griffin recurrent block. x: (B, S, D)."""
    return rglru_prefill(cfg, p, x)[0]


def init_rglru_cache(cfg, batch: int, dtype=torch.float32,
                     device="cuda") -> dict:
    g = cfg.rglru
    w = g.lru_width(cfg.d_model)
    dev = require_device(device)
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, g.conv_width - 1, w), dtype=dtype,
                            device=dev),
    }


def apply_rglru_decode(cfg, p: dict, x: torch.Tensor, cache: dict):
    """Single-token step. x: (B, 1, D) -> (out (B, 1, D), new cache)."""
    dt = x.dtype
    x1 = x[:, 0, :]
    br = gelu(x1 @ p["w_branch"].to(dt))
    u_new = x1 @ p["w_rec"].to(dt)
    window = torch.cat([cache["conv"], u_new[:, None, :]], dim=1)
    u = torch.einsum("bwc,wc->bc", window, p["conv"].to(dt))
    a_log, b = _gates(p, u)
    h = torch.exp(a_log) * cache["h"] + b
    out = (h.to(dt) * br) @ p["wo"].to(dt)
    return out[:, None, :], {"h": h, "conv": window[:, 1:, :]}
