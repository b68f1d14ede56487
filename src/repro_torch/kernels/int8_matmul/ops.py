"""int8 x int8 -> int32 matmul with per-row / per-column float32 scales: the
hand-written CUDA kernel on the card, its plain version on the CPU.

Replaces the reference's Pallas `int8_matmul_kernel`
(`repro/kernels/int8_matmul/kernel.py`, body `_int8_mm_kernel`), which
`quantized_linear` and the int8 FFN walkthrough
(`repro_torch.examples.int8_serving`) run. Source: `csrc/int8_matmul.cu`."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.int8_matmul.ref import (int8_matmul_acc_ref,
                                                 int8_matmul_ref,
                                                 quantize_cols, quantize_rows)

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.register(build.CudaKernel(
    "int8_matmul", "int8_matmul", "int8_matmul_fwd",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]))


def _check(x_q: torch.Tensor, w_q: torch.Tensor):
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"int8_matmul: bad shapes x{tuple(x_q.shape)} "
                         f"w{tuple(w_q.shape)}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul: operands must be int8, got "
                        f"{x_q.dtype}/{w_q.dtype}")
    if min(x_q.shape[0], x_q.shape[1], w_q.shape[1]) == 0:
        raise ValueError("int8_matmul: empty operand")
    return x_q.contiguous(), w_q.contiguous()


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor) -> torch.Tensor:
    """x_q: (M, K) int8; w_q: (K, N) int8; sx: (M, 1) float32; sw: (1, N)
    float32 -> (M, N) float32 = (float(x_q @ w_q) * sx) * sw."""
    if x_q.device.type != "cuda":
        return int8_matmul_ref(x_q, w_q, sx, sw)
    x_q, w_q = _check(x_q, w_q)
    M, K = x_q.shape
    N = w_q.shape[1]
    if (sx.numel() != M or sw.numel() != N or sx.dtype != torch.float32
            or sw.dtype != torch.float32):
        raise ValueError(f"int8_matmul: scales must be float32 ({M}, 1) and "
                         f"(1, {N}), got {sx.dtype} {tuple(sx.shape)} / "
                         f"{sw.dtype} {tuple(sw.shape)}")
    sx, sw = sx.contiguous(), sw.contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    KERNEL(build.ptr(x_q), build.ptr(w_q), build.ptr(sx), build.ptr(sw),
           build.ptr(out), None, M, N, K, build.stream_ptr(x_q))
    return out


def int8_matmul_acc(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The kernel without its epilogue: the exact int32 products x_q @ w_q,
    for checks that hold the accumulation itself against the plain
    version."""
    if x_q.device.type != "cuda":
        return int8_matmul_acc_ref(x_q, w_q)
    x_q, w_q = _check(x_q, w_q)
    M, K = x_q.shape
    N = w_q.shape[1]
    acc = torch.empty((M, N), dtype=torch.int32, device=x_q.device)
    KERNEL(build.ptr(x_q), build.ptr(w_q), None, None, None, build.ptr(acc),
           M, N, K, build.stream_ptr(x_q))
    return acc


def quantized_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Full path: quantize float activations (per row) and weights (per
    column), int8 matmul, dequantize. x: (M, K); w: (K, N) -> (M, N)
    float32."""
    x_q, sx = quantize_rows(x)
    w_q, sw = quantize_cols(w)
    return int8_matmul(x_q, w_q, sx, sw)
