"""Dense-cache GQA decode attention: the hand-written CUDA kernel on the
card, its plain version on the CPU.

`gqa_decode` replaces the reference's Pallas `gqa_decode_kernel`
(`repro/kernels/gqa_decode/kernel.py`, body `_decode_kernel`). The port's
dense decode step (`models.attention.decode_attention`) calls it for every
layer of every step, where the reference runs a jnp einsum of the same
function. The kernel reads the cache through the strides it is given, so
the decode step passes the (B, K, T, d) view of its (B, T, K, d) cache
without a copy. Source: `csrc/gqa_decode.cu` over the kernel template
`csrc/decode_attention.cuh`, shared with paged decode and verification."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gqa_decode.ref import SPLIT_ROWS, gqa_decode_ref

# dtype codes of csrc/common.cuh
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CACHE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
KERNEL = build.register(build.CudaKernel(
    "gqa_decode", "gqa_decode", "gqa_decode_fwd",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, ctypes.c_float,
     _I, _I, _I, _P]))


def num_splits(T: int) -> int:
    """Split blocks per (sequence, KV head): a function of T alone."""
    return -(-T // SPLIT_ROWS)


def _aligned(k: torch.Tensor, v: torch.Tensor) -> tuple:
    """k, v as the kernel's 16-byte row copies need them: every row start
    16-byte aligned, k and v with equal strides. Views that are not (an odd
    offset or stride) are copied contiguous; the decode step's (B, K, T, d)
    view of its cache needs no copy."""
    vec = 16 // k.element_size()
    ok = (k.stride() == v.stride() and k.stride(-1) == 1
          and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
          and all(st % vec == 0 for st in k.stride()[:3]))
    return (k, v) if ok else (k.contiguous(), v.contiguous())


def check_dense(q, k, v, lengths) -> tuple:
    """The dense kernel's shapes, types and limits: any GQA group (a KV
    head's query rows run in chunks of `csrc/decode_attention.cuh`'s
    `split_chunk_rows`), a head dim up to MAX_HEAD_DIM that is a whole
    number of 16-byte pieces. Returns (B, H, K, d, T)."""
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
    if d > MAX_HEAD_DIM:
        raise ValueError(f"gqa_decode: head_dim {d} beyond the kernel's "
                         f"{MAX_HEAD_DIM}")
    if (d * k.element_size()) % 16:
        raise ValueError(f"gqa_decode: head_dim {d} of {k.dtype} is not a "
                         f"whole number of 16-byte pieces")
    return B, H, K, d, T


def gqa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, d) float32/bfloat16; k, v: (B, K, T, d) float32, bfloat16
    or float16, any strides with d contiguous (k and v alike); lengths:
    (B,) int32 valid rows (past T: all T). -> (B, H, d) in q's dtype.

    Query head h reads KV head h // (H // K). On the card the kernel runs
    `num_splits(T)` blocks per (KV head, sequence), each over a fixed
    slice of SPLIT_ROWS cache rows, into a float32 workspace, then merges
    the slices in a fixed order: a sequence's output does not depend on
    the batch it shares a call with. It copies rows in 16-byte pieces, so
    d must be a multiple of 16 bytes' worth of elements, and a view whose
    rows are not 16-byte aligned is copied first. On the CPU it runs
    `gqa_decode_ref`."""
    if q.device.type != "cuda":
        return gqa_decode_ref(q, k, v, lengths)
    B, H, K, d, T = check_dense(q, k, v, lengths)
    q = q.contiguous()
    k, v = _aligned(k, v)
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    nsplit = num_splits(T)
    # per (sequence, KV head, split): m and l of each query row, then its d
    # accumulators
    work = torch.empty(B * K * nsplit * (H // K) * (d + 2),
                       dtype=torch.float32, device=q.device)
    sb, sk, st, _ = k.stride()
    KERNEL(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(lens),
           build.ptr(out), build.ptr(work), B, H, K, d, T, sb, sk, st,
           1.0 / math.sqrt(d), Q_DTYPES[q.dtype], CACHE_DTYPES[k.dtype],
           nsplit, build.stream_ptr(q))
    return out
