"""Causal prefill attention: the hand-written CUDA kernel on the card, its
plain version on the CPU.

Replaces the reference's prefill attention: the Pallas
`flash_attention_kernel` (`repro/kernels/flash_attention/kernel.py`) and
the jnp `blocked_attention` the reference prefill runs
(`repro/models/attention.py`), which compute the same function. Unlike the
Pallas kernel (which asserts S % block == 0) it takes ragged prompt lengths
by masking. Source: `csrc/flash_attention.cu`."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.register(build.CudaKernel(
    "flash_attention", "flash_attention", "flash_attention_fwd",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]))


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal attention. q: (B, S, H, h); k, v: (B, T, K, h), H % K == 0;
    query row s attends keys t <= s. Returns (B, S, H, h) in q's dtype."""
    if q.device.type != "cuda":
        return flash_attention_ref(q, k, v)
    B, S, H, d = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape != (B, T, K, d) or v.shape != k.shape or H % K:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    KERNEL(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), B, S, T,
           H, K, d, 1.0 / math.sqrt(d), DTYPES[q.dtype], build.stream_ptr(q))
    return out
