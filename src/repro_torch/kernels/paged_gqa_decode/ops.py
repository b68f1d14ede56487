"""Paged GQA decode attention: the hand-written CUDA kernels on the card,
their plain versions on the CPU.

`paged_gqa_decode` replaces the reference's Pallas `paged_gqa_decode_kernel`
(`repro/kernels/paged_gqa_decode/kernel.py`, body `_paged_decode_kernel`) for
float32 / bfloat16 / float16 pools and fp8 E4M3 code pools (uint8) under a
float32 or bfloat16 query; `paged_gqa_decode_quant` replaces
`paged_gqa_decode_quant_kernel` (body `_paged_decode_quant_kernel`) for int8
pools with per-row float32 scales. The paged decode step calls one of them
for every token of every layer. Both launch from
`csrc/paged_gqa_decode.cu`, as two kernels with their own launch counts,
and run the split-context kernels of `csrc/decode_attention.cuh`, which
verification and `gqa_decode` run too."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gqa_decode.ops import num_splits
from repro_torch.kernels.paged_gqa_decode.ref import (
    paged_gqa_decode_quant_ref, paged_gqa_decode_ref)
from repro_torch.kernels.quant import FP8_STORAGE_DTYPE

# dtype codes of csrc/common.cuh; uint8 pools hold fp8 E4M3 codes
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               FP8_STORAGE_DTYPE: 3}
MAX_HEAD_DIM = 256
MAX_GROUP = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
KERNEL = build.register(build.CudaKernel(
    "paged_gqa_decode", "paged_gqa_decode", "paged_gqa_decode_fwd",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I,
     _P]))
QUANT_KERNEL = build.register(build.CudaKernel(
    "paged_gqa_decode_quant", "paged_gqa_decode", "paged_gqa_decode_quant_fwd",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
     _I, _P]))


def check_paged(name, q, k_pages, v_pages, page_table, lengths):
    """Shapes, types and limits the paged kernels share (q: (B, H, d), one
    window row); returns (B, H, K, d, ps, P, N) and the int32 table and
    lengths."""
    B, H, d = q.shape
    N, K, ps, _ = k_pages.shape
    P = page_table.shape[1]
    if (k_pages.shape != (N, K, ps, d) or v_pages.shape != k_pages.shape
            or v_pages.dtype != k_pages.dtype or H % K
            or page_table.shape[0] != B or lengths.shape != (B,)):
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"pools{tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} "
                         f"table{tuple(page_table.shape)} "
                         f"lengths{tuple(lengths.shape)}")
    if q.dtype not in Q_DTYPES:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    if d > MAX_HEAD_DIM or H // K > MAX_GROUP:
        raise ValueError(f"{name}: head_dim {d} / group {H // K} beyond the "
                         f"kernel's {MAX_HEAD_DIM} / {MAX_GROUP}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError(f"{name}: page pools must be contiguous")
    table = page_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    return (B, H, K, d, ps, P, N), table, lens


def check_split(name, k_pages, v_pages):
    """The kernels copy pool rows in 16-byte pieces: the head dim must be a
    whole number of them (a multiple of 4 float32, 8 bfloat16 / float16 or
    16 fp8 / int8 elements) and the pools 16-byte aligned."""
    d, vec = k_pages.shape[-1], 16 // k_pages.element_size()
    if d % vec or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{name}: head_dim {d} must be a multiple of {vec} "
                         f"for {k_pages.dtype} pools and the pools 16-byte "
                         f"aligned")


def split_workspace(q, dims, rows) -> tuple:
    """(nsplit, workspace) of a paged call with `rows` query rows per KV
    head: `num_splits(P * ps)` splits per (slot, KV head), each holding m
    and l of every query row, then its d accumulators."""
    B, H, K, d, ps, P, N = dims
    nsplit = num_splits(P * ps)
    return nsplit, torch.empty(B * K * nsplit * rows * (d + 2),
                               dtype=torch.float32, device=q.device)


def paged_gqa_decode(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, page_table: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, d) float32/bfloat16; k_pages, v_pages: (N, K, ps, d)
    float32, bfloat16, float16 or fp8 E4M3 codes (uint8), read as float32
    whatever q's dtype; page_table: (B, P) int32 page ids;
    lengths: (B,) int32 true context sizes. -> (B, H, d) in q's dtype.

    Query head h reads KV head h // (H // K). Lengths past P*ps are clamped
    to the table, so a slot whose table points at the null page reads only
    in-bounds rows.

    On the card the kernel runs `num_splits(P * ps)` blocks per (KV head,
    slot), each over a fixed slice of 64 table rows, into a float32
    workspace, then merges the slices in a fixed order
    (`paged_gqa_decode_split_ref` repeats its arithmetic); the split count
    depends on the table's width only, so reading it needs no host sync and
    a slot's output does not depend on its batch. See `check_split` for the
    head dims and alignment it takes."""
    if q.device.type != "cuda":
        return paged_gqa_decode_ref(q, k_pages, v_pages, page_table, lengths)
    dims, table, lens = check_paged("paged_gqa_decode", q, k_pages,
                                    v_pages, page_table, lengths)
    if k_pages.dtype not in POOL_DTYPES:
        raise TypeError(f"paged_gqa_decode: pools must be float32, bfloat16, "
                        f"float16 or fp8 codes, got {k_pages.dtype}")
    check_split("paged_gqa_decode", k_pages, v_pages)
    B, H, K, d, ps, P, N = dims
    q = q.contiguous()
    out = torch.empty_like(q)
    nsplit, work = split_workspace(q, dims, H // K)
    KERNEL(build.ptr(q), build.ptr(k_pages), build.ptr(v_pages),
           build.ptr(table), build.ptr(lens), build.ptr(out), build.ptr(work),
           B, H, K, d, ps, P, N, 1.0 / math.sqrt(d), Q_DTYPES[q.dtype],
           POOL_DTYPES[k_pages.dtype], nsplit, build.stream_ptr(q))
    return out


def paged_gqa_decode_quant(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """int8-page variant: k_pages, v_pages (N, K, ps, d) int8 with per-row
    float32 scales k_scale, v_scale (N, K, ps); otherwise as
    `paged_gqa_decode`. -> (B, H, d) in q's dtype.

    On the card it runs as `paged_gqa_decode` does
    (`paged_gqa_decode_quant_split_ref` repeats its arithmetic): d must be
    a multiple of 16 and the pools 16-byte aligned."""
    if q.device.type != "cuda":
        return paged_gqa_decode_quant_ref(q, k_pages, v_pages, k_scale,
                                          v_scale, page_table, lengths)
    dims, table, lens = check_paged("paged_gqa_decode_quant", q, k_pages,
                                    v_pages, page_table, lengths)
    B, H, K, d, ps, P, N = dims
    if k_pages.dtype != torch.int8:
        raise TypeError(f"paged_gqa_decode_quant: pools must be int8, got "
                        f"{k_pages.dtype}")
    for s in (k_scale, v_scale):
        if (s.shape != (N, K, ps) or s.dtype != torch.float32
                or not s.is_contiguous()):
            raise ValueError(f"paged_gqa_decode_quant: scales must be "
                             f"contiguous float32 {(N, K, ps)}, got "
                             f"{s.dtype} {tuple(s.shape)}")
    check_split("paged_gqa_decode_quant", k_pages, v_pages)
    q = q.contiguous()
    out = torch.empty_like(q)
    nsplit, work = split_workspace(q, dims, H // K)
    QUANT_KERNEL(build.ptr(q), build.ptr(k_pages), build.ptr(v_pages),
                 build.ptr(k_scale), build.ptr(v_scale), build.ptr(table),
                 build.ptr(lens), build.ptr(out), build.ptr(work), B, H, K,
                 d, ps, P, N, 1.0 / math.sqrt(d), Q_DTYPES[q.dtype], nsplit,
                 build.stream_ptr(q))
    return out
