"""Dense-cache GQA decode attention: the hand-written CUDA kernel on the
card, its plain version on the CPU.

`gqa_decode` replaces the reference's Pallas `gqa_decode_kernel`
(`repro/kernels/gqa_decode/kernel.py`, body `_decode_kernel`). The port's
dense decode step (`models.attention.decode_attention`) calls it for every
layer of every step, where the reference runs a jnp einsum of the same
function. The kernel reads the cache through the strides it is given, so
the decode step passes the (B, K, T, d) view of its (B, T, K, d) cache
without a copy. Source: `csrc/gqa_decode.cu` (the kernel template is
`csrc/decode_attention.cuh`, shared with paged decode)."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gqa_decode.ref import gqa_decode_ref

# dtype codes of csrc/common.cuh
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CACHE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 256
# query rows a block holds (the group), and rows x head_dim: see
# csrc/decode_attention.cuh kMaxRows and kThreads * kMaxAcc
MAX_ROWS = 64
MAX_ROW_ELEMS = 4096

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
KERNEL = build.register(build.CudaKernel(
    "gqa_decode", "gqa_decode", "gqa_decode_fwd",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, ctypes.c_float, _I,
     _I, _P]))


def gqa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, d) float32/bfloat16; k, v: (B, K, T, d) float32, bfloat16
    or float16, any strides with d contiguous (k and v alike); lengths:
    (B,) int32 valid rows (past T: all T). -> (B, H, d) in q's dtype.

    Query head h reads KV head h // (H // K)."""
    if q.device.type != "cuda":
        return gqa_decode_ref(q, k, v, lengths)
    B, H, d = q.shape
    _, K, T, _ = k.shape
    if (k.shape != (B, K, T, d) or v.shape != k.shape or v.dtype != k.dtype
            or H % K or lengths.shape != (B,)):
        raise ValueError(f"gqa_decode: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"lengths{tuple(lengths.shape)}")
    if q.dtype not in Q_DTYPES or k.dtype not in CACHE_DTYPES:
        raise TypeError(f"gqa_decode: q must be float32 or bfloat16 and the "
                        f"cache float32, bfloat16 or float16; got {q.dtype} "
                        f"/ {k.dtype}")
    if d > MAX_HEAD_DIM or H // K > MAX_ROWS or H // K * d > MAX_ROW_ELEMS:
        raise ValueError(f"gqa_decode: head_dim {d} / group {H // K} beyond "
                         f"the kernel's {MAX_HEAD_DIM} / {MAX_ROWS} / "
                         f"{MAX_ROW_ELEMS} accumulators")
    if k.stride() != v.stride() or k.stride(-1) != 1:
        raise ValueError(f"gqa_decode: k and v need equal strides with d "
                         f"contiguous, got {k.stride()} / {v.stride()}")
    q = q.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    sb, sk, st, _ = k.stride()
    KERNEL(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(lens),
           build.ptr(out), B, H, K, d, T, sb, sk, st, 1.0 / math.sqrt(d),
           Q_DTYPES[q.dtype], CACHE_DTYPES[k.dtype], build.stream_ptr(q))
    return out
