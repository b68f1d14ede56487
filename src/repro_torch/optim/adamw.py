"""AdamW with global-norm clipping over a tree of tensors; port of the
reference's `repro/optim/adamw.py`. Updates are functional, as the
reference's: `update` returns new parameter and state trees and leaves its
inputs untouched (no `torch.optim`). The state holds the step and the two
float32 moment trees (m, v) mirroring the parameters."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.optim.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


@dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]   # schedule: step -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: Any) -> AdamWState:
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        device = tree_leaves(params)[0].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          zeros, tree_map(torch.clone, zeros))

    def update(self, grads: Any, state: AdamWState,
               params: Any) -> Tuple[Any, AdamWState, dict]:
        grads = tree_map(lambda g: g.float(), grads)
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        grads = tree_map(lambda g: g * scale, grads)

        step = state.step + 1
        lr = self.lr(step)
        b1c = 1.0 - torch.pow(self.b1, step.float())
        b2c = 1.0 - torch.pow(self.b2, step.float())

        new_m = tree_map(lambda m, g: self.b1 * m + (1 - self.b1) * g,
                         state.m, grads)
        new_v = tree_map(lambda v, g: self.b2 * v + (1 - self.b2) * g * g,
                         state.v, grads)

        def upd(p, m, v):
            delta = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            if self.weight_decay > 0:
                delta = delta + self.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype)

        new_params = tree_map(upd, params, new_m, new_v)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return new_params, AdamWState(step, new_m, new_v), metrics


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32; leaves summed
    in flattening order."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
