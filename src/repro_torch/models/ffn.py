"""Feed-forward variants: SwiGLU (dsr1d-qwen, olmoe, llama4, internvl2),
GELU MLP (gpt2-xl) and GeGLU (recurrentgemma); port of the reference's
`repro/models/ffn.py`. The projections are plain matrix products, as the
reference leaves them to XLA."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import gelu


def apply_ffn(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if cfg.ffn_kind == "swiglu":
        g = F.silu(x @ p["w_gate"].to(dt))
        u = x @ p["w_up"].to(dt)
        return (g * u) @ p["w_down"].to(dt)
    if cfg.ffn_kind == "geglu":
        g = gelu(x @ p["w_gate"].to(dt))
        u = x @ p["w_up"].to(dt)
        return (g * u) @ p["w_down"].to(dt)
    if cfg.ffn_kind == "gelu_mlp":
        h = gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt))
        return h @ p["w_down"].to(dt) + p["b_down"].to(dt)
    raise NotImplementedError(f"ffn_kind {cfg.ffn_kind!r} is not ported")
