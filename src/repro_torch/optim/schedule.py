"""Learning-rate schedules (port of `repro/optim/schedule.py`): functions
of the step tensor returning a float32 tensor."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                       min_ratio: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def constant(lr_value: float):
    def lr(step):
        return torch.full((), lr_value, dtype=torch.float32,
                          device=torch.as_tensor(step).device)
    return lr
