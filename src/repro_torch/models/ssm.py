"""Mamba-2 SSD (state-space duality) block: the chunked matrix form for
prefill, the single-step recurrence for decode; port of the reference's
`repro/models/ssm.py` (mamba2).

Chunked SSD (Dao & Gu 2024): within a chunk the output is a masked
attention-like quadratic term; across chunks a small recurrence carries the
(H, P, N) state. Both forms are exact. The port runs the inter-chunk
recurrence as a loop over the chunks, as the reference's `lax.scan`."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import require_device


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv then SiLU: x (B, S, C), w (cw, C)."""
    cw = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + xp[:, i:i + S, :] * w[i]
    return F.silu(out)


def _conv_step(x_new: torch.Tensor, buf: torch.Tensor, w: torch.Tensor):
    """Single-token causal conv. x_new (B, C), buf (B, cw - 1, C) past
    inputs. Returns (silu(out) (B, C), new buf)."""
    window = torch.cat([buf, x_new[:, None, :]], dim=1)          # (B, cw, C)
    out = torch.einsum("bwc,wc->bc", window, w)
    return F.silu(out), window[:, 1:, :]


def _gated_out(p: dict, y: torch.Tensor, z: torch.Tensor,
               dtype) -> torch.Tensor:
    """y * silu(z) -> RMSNorm -> out projection."""
    g = y * F.silu(z.float())
    var = g.square().mean(-1, keepdim=True)
    g = g * torch.rsqrt(var + 1e-6) * (1.0 + p["norm"].float())
    return g.to(dtype) @ p["wo"].to(dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact chunked SSD.

    x: (b, S, H, P) head inputs; dt: (b, S, H) positive step sizes; A: (H,)
    negative decay rates; B, C: (b, S, N) input/output projections (one
    group). Returns (y (b, S, H, P) float32, final state (b, H, P, N))."""
    b, S, H, Pd = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    nc = S // Q

    xq = x.reshape(b, nc, Q, H, Pd).float()
    dtq = dt.reshape(b, nc, Q, H).float()
    Bq = B.reshape(b, nc, Q, N).float()
    Cq = C.reshape(b, nc, Q, N).float()

    la = dtq * A[None, None, None, :]              # log decay per step (<= 0)
    cum = torch.cumsum(la, dim=2)                  # (b, nc, Q, H)

    # intra-chunk (quadratic, causal-masked): L[i, j] = exp(cum_i - cum_j)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (b,nc,Q,Q,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.where(mask[None, None, :, :, None], torch.exp(diff),
                    torch.zeros((), device=x.device))
    scores = torch.einsum("bcin,bcjn->bcij", Cq, Bq)         # (b,nc,Q,Q)
    M = scores[..., None] * L * dtq[:, :, None, :, :]        # weight dt_j
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xq)

    # chunk states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)        # (b,nc,Q,H)
    ZB = Bq[:, :, :, None, :] * (dtq * decay_to_end)[..., None]
    S_c = torch.einsum("bcqhn,bcqhp->bchpn", ZB, xq)         # (b,nc,H,P,N)
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (b,nc,H)

    # inter-chunk recurrence, sequential over the chunks
    s = (torch.zeros((b, H, Pd, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    prevs = []
    for c in range(nc):
        prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + S_c[:, c]
    S_prev = torch.stack(prevs, dim=1)                       # (b,nc,H,P,N)

    Cdec = Cq[:, :, :, None, :] * torch.exp(cum)[..., None]  # (b,nc,Q,H,N)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", Cdec, S_prev)

    y = (y_intra + y_inter).reshape(b, S, H, Pd)
    return y, s


def ssd_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
             A: torch.Tensor, B: torch.Tensor, C: torch.Tensor):
    """Single-token recurrence. state (b, H, P, N); x (b, H, P); dt (b, H);
    B, C (b, N). Returns (y (b, H, P), new state)."""
    a = torch.exp(dt.float() * A[None, :])                   # (b, H)
    upd = (dt.float()[:, :, None, None] * x.float()[..., None]
           * B.float()[:, None, None, :])
    new_state = state * a[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C.float())
    return y, new_state


def _dt_and_A(p: dict, x: torch.Tensor):
    dt = F.softplus((x @ p["wdt"].to(x.dtype)).float()
                    + p["dt_bias"].float())
    return dt, -torch.exp(p["A_log"].float())


def ssm_prefill(cfg, p: dict, x: torch.Tensor):
    """Full-sequence SSD block that also returns its final state (the
    reference's `transformer._ssm_prefill`). x: (b, S, D) -> (out,
    {"state", "conv_x", "conv_B", "conv_C"}), the conv buffers the last
    conv_width - 1 rows of each conv input."""
    s = cfg.ssm
    b, S, D = x.shape
    di = s.d_inner(D)
    H = s.num_heads(D)
    dt_ = x.dtype
    z = x @ p["wz"].to(dt_)
    x_lin = x @ p["wx"].to(dt_)
    B_lin = x @ p["wB"].to(dt_)
    C_lin = x @ p["wC"].to(dt_)
    xin = _causal_conv(x_lin, p["conv_x"].to(dt_))
    Bt = _causal_conv(B_lin, p["conv_B"].to(dt_))
    Ct = _causal_conv(C_lin, p["conv_C"].to(dt_))
    dt, A = _dt_and_A(p, x)
    xh = xin.reshape(b, S, H, s.head_dim)
    y, final_state = ssd_chunked(xh, dt, A, Bt, Ct, s.chunk_size)
    y = y + xh.float() * p["D"].float()[None, None, :, None]
    out = _gated_out(p, y.reshape(b, S, di), z, dt_)
    cw = s.conv_width
    return out, {"state": final_state,
                 "conv_x": x_lin[:, -(cw - 1):, :],
                 "conv_B": B_lin[:, -(cw - 1):, :],
                 "conv_C": C_lin[:, -(cw - 1):, :]}


def apply_ssm(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD block. x: (b, S, D)."""
    return ssm_prefill(cfg, p, x)[0]


def init_ssm_cache(cfg, batch: int, dtype=torch.float32,
                   device="cuda") -> dict:
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    H = s.num_heads(cfg.d_model)
    dev = require_device(device)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    return {"state": z(batch, H, s.head_dim, s.state_dim, dt=torch.float32),
            "conv_x": z(batch, s.conv_width - 1, di),
            "conv_B": z(batch, s.conv_width - 1, s.state_dim),
            "conv_C": z(batch, s.conv_width - 1, s.state_dim)}


def apply_ssm_decode(cfg, p: dict, x: torch.Tensor, cache: dict):
    """Single-token step. x: (b, 1, D) -> (y (b, 1, D), new cache)."""
    s = cfg.ssm
    b, _, D = x.shape
    di = s.d_inner(D)
    H = s.num_heads(D)
    dt_ = x.dtype
    x1 = x[:, 0, :]
    z = x1 @ p["wz"].to(dt_)
    xin, cx = _conv_step(x1 @ p["wx"].to(dt_), cache["conv_x"],
                         p["conv_x"].to(dt_))
    Bt, cB = _conv_step(x1 @ p["wB"].to(dt_), cache["conv_B"],
                        p["conv_B"].to(dt_))
    Ct, cC = _conv_step(x1 @ p["wC"].to(dt_), cache["conv_C"],
                        p["conv_C"].to(dt_))
    dt, A = _dt_and_A(p, x1)
    xh = xin.reshape(b, H, s.head_dim)
    y, new_state = ssd_step(cache["state"], xh, dt, A, Bt, Ct)
    y = y + xh.float() * p["D"].float()[None, :, None]
    out = _gated_out(p, y.reshape(b, di), z, dt_)
    return out[:, None, :], {"state": new_state, "conv_x": cx,
                             "conv_B": cB, "conv_C": cC}
