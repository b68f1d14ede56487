"""Paged GQA decode attention: the hand-written CUDA kernel on the card, its
plain version on the CPU.

Replaces the reference's Pallas `paged_gqa_decode_kernel`
(`repro/kernels/paged_gqa_decode/kernel.py`, body `_paged_decode_kernel`),
which the paged decode step calls for every token of every layer. Native
float32 / bfloat16 page pools only: the int8 and fp8 pools of the reference
are not ported yet. Source: `csrc/paged_gqa_decode.cu`."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_gqa_decode.ref import paged_gqa_decode_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GROUP = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.register(build.CudaKernel(
    "paged_gqa_decode", "paged_gqa_decode", "paged_gqa_decode_fwd",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I,
     _P]))


def paged_gqa_decode(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, page_table: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, d); k_pages, v_pages: (N, K, ps, d); page_table: (B, P)
    int32 page ids; lengths: (B,) int32 true context sizes. -> (B, H, d).

    Query head h reads KV head h // (H // K). Lengths past P*ps are clamped
    to the table, so a slot whose table points at the null page reads only
    in-bounds rows."""
    if q.device.type != "cuda":
        return paged_gqa_decode_ref(q, k_pages, v_pages, page_table, lengths)
    B, H, d = q.shape
    N, K, ps, _ = k_pages.shape
    P = page_table.shape[1]
    if (k_pages.shape != (N, K, ps, d) or v_pages.shape != k_pages.shape
            or H % K or page_table.shape[0] != B or lengths.shape != (B,)):
        raise ValueError(f"bad shapes q{tuple(q.shape)} "
                         f"pools{tuple(k_pages.shape)} "
                         f"table{tuple(page_table.shape)} "
                         f"lengths{tuple(lengths.shape)}")
    if (q.dtype not in DTYPES or k_pages.dtype != q.dtype
            or v_pages.dtype != q.dtype):
        raise TypeError(f"paged_gqa_decode takes float32 or bfloat16, got "
                        f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if d > MAX_HEAD_DIM or H // K > MAX_GROUP:
        raise ValueError(f"head_dim {d} / group {H // K} beyond the kernel's "
                         f"{MAX_HEAD_DIM} / {MAX_GROUP}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("page pools must be contiguous")
    q = q.contiguous()
    table = page_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    KERNEL(build.ptr(q), build.ptr(k_pages), build.ptr(v_pages),
           build.ptr(table), build.ptr(lens), build.ptr(out), B, H, K, d, ps,
           P, N, 1.0 / math.sqrt(d), DTYPES[q.dtype], build.stream_ptr(q))
    return out
