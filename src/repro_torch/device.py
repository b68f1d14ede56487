"""Device selection shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU; a request
for CUDA on a host without a card raises instead of falling back."""
from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """`device` as a `torch.device`; raises if it names CUDA and no card is
    present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           "is available; pass device='cpu' to run the "
                           "plain PyTorch path")
    return dev
