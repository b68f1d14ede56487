"""int8 x int8 -> int32 matmul with per-row / per-column float32 scales: the
hand-written CUDA kernel on the card, its plain version on the CPU.

Replaces the reference's Pallas `int8_matmul_kernel`
(`repro/kernels/int8_matmul/kernel.py`, body `_int8_mm_kernel`), which
`quantized_linear` and the int8 FFN walkthrough
(`repro_torch.examples.int8_serving`) run. Source: `csrc/int8_matmul.cu`
(tensor-core tiles of 128 x 128; K split across blocks when the output has
fewer tiles than the card has SMs)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.int8_matmul.ref import (int8_matmul_acc_ref,
                                                 int8_matmul_ref,
                                                 quantize_cols, quantize_rows)

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.register(build.CudaKernel(
    "int8_matmul", "int8_matmul", "int8_matmul_fwd",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]))
# output tile and k-tile of csrc/int8_matmul.cu (kBM, kBN, kBK)
TILE, K_TILE = 128, 128
# a block's cost beyond its k-tiles (filling the ring, the epilogue), in
# k-tiles: an estimate that keeps split products from slicing K thinner
# than their atomics are worth
BLOCK_COST = 2


def split_k(M: int, N: int, K: int, sms: int) -> int:
    """Slices of K for an (M, K) x (K, N) product on a card of `sms` SMs,
    which run one 128 x 128 output tile at a time each: 1 when the output
    tiles fill the card (a split output costs a pass of int32 atomics),
    else the count that minimises rounds of blocks x (k-tiles per slice +
    BLOCK_COST), the fewest slices among equals; each slice is whole
    128-byte k-tiles. The int32 sums are exact in any order, so the result
    does not depend on the count."""
    tiles = -(-M // TILE) * -(-N // TILE)
    ktiles = -(-K // K_TILE)
    if tiles >= sms:
        return 1
    return min(range(1, ktiles + 1),
               key=lambda s: (-(-tiles * s // sms)
                              * (-(-ktiles // s) + BLOCK_COST), s))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(x_q, w_q, sx, sw, out, acc):
    """One kernel call; a split product sums into `acc` (allocated here for
    a scaled product)."""
    M, K = x_q.shape
    N = w_q.shape[1]
    splits = split_k(M, N, K, _sm_count(x_q.device.index or 0))
    if acc is None and splits > 1:
        acc = torch.empty((M, N), dtype=torch.int32, device=x_q.device)
    KERNEL(build.ptr(x_q), build.ptr(w_q),
           None if sx is None else build.ptr(sx),
           None if sw is None else build.ptr(sw),
           None if out is None else build.ptr(out),
           None if acc is None else build.ptr(acc), M, N, K, splits,
           build.stream_ptr(x_q))


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
    _launch(x_q, w_q, sx, sw, out, None)
    return out


def int8_matmul_acc(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The kernel without its epilogue: the exact int32 products x_q @ w_q,
    for checks that hold the accumulation itself against the plain
    version."""
    if x_q.device.type != "cuda":
        return int8_matmul_acc_ref(x_q, w_q)
    x_q, w_q = _check(x_q, w_q)
    acc = torch.empty((x_q.shape[0], w_q.shape[1]), dtype=torch.int32,
                      device=x_q.device)
    _launch(x_q, w_q, None, None, None, acc)
    return acc


def quantized_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Full path: quantize float activations (per row) and weights (per
    column), int8 matmul, dequantize. x: (M, K); w: (K, N) -> (M, N)
    float32."""
    x_q, sx = quantize_rows(x)
    w_q, sw = quantize_cols(w)
    return int8_matmul(x_q, w_q, sx, sw)
