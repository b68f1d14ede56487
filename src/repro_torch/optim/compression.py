"""Gradient compression (port of `repro/optim/compression.py`).

  * bf16   — cast gradients to bf16 (half the bytes of a data-parallel
             all-reduce);
  * int8ef — symmetric per-leaf int8 with error feedback: the
             quantization residual is carried into the next step, keeping
             the compressed direction unbiased over time.

`train/step.py` applies it between the gradients and the optimizer."""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.optim.tree import tree_map


def compress_bf16(grads: Any) -> Any:
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def init_error_state(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def compress_int8_ef(grads: Any, err: Any) -> Tuple[Any, Any]:
    """Returns (dequantized grads to feed the optimizer, new error state):
    q = round(clip((g + e) / s)) with s = max|g + e| / 127 per leaf (at
    least 1e-12 / 127), e' = (g + e) - q s."""
    def one(g, e):
        x = g.float() + e
        s = torch.clamp(x.abs().max(), min=1e-12) / 127.0
        deq = torch.clamp(torch.round(x / s), -127, 127) * s
        return deq, x - deq
    pairs = tree_map(one, grads, err)
    return (tree_map(lambda g, pr: pr[0], grads, pairs),
            tree_map(lambda g, pr: pr[1], grads, pairs))


def apply_compression(grads: Any, mode: str,
                      err: Optional[Any] = None) -> Tuple[Any, Optional[Any]]:
    if mode == "none":
        return grads, err
    if mode == "bf16":
        return compress_bf16(grads), err
    if mode == "int8ef":
        assert err is not None
        return compress_int8_ef(grads, err)
    raise ValueError(mode)
