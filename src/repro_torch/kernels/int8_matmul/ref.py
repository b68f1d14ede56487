"""Plain PyTorch version of the int8 matmul (reference:
`repro/kernels/int8_matmul/ref.py`), with the quantization helpers it pairs
with re-exported from the port's `kernels.quant`.

The int32 accumulation is taken as a float64 product: every partial sum is
an integer below K * 127**2 < 2**53, so it is exact in any order, and it
runs on the CPU and on the card alike (CUDA has no int32 `matmul`)."""
from __future__ import annotations

import torch

from repro_torch.kernels.quant import quantize_cols, quantize_rows  # noqa: F401


def int8_matmul_acc_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K) int8; w: (K, N) int8 -> the exact int32 products (M, N)."""
    return (x.double() @ w.double()).to(torch.int32)


def int8_matmul_ref(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                    sw: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """(float(x @ w) * sx) * sw with sx (M, 1) and sw (1, N) float32."""
    acc = int8_matmul_acc_ref(x, w)
    return (acc.float() * sx.float() * sw.float()).to(out_dtype)
