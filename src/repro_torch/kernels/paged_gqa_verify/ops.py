"""Paged GQA speculative verification: the hand-written CUDA kernel on the
card, its plain version on the CPU.

`paged_gqa_verify` replaces the reference's Pallas `paged_gqa_verify_kernel`
(`repro/kernels/paged_gqa_verify/kernel.py`, body `_paged_verify_kernel`)
for float32 / bfloat16 / float16 pools and fp8 E4M3 code pools (uint8)
under a float32 or bfloat16 query. The speculative verify step calls it
once per target layer per round. Source: `csrc/paged_gqa_verify.cu`, over
the split-context kernels of `csrc/decode_attention.cuh` that paged decode
runs, row for row."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_gqa_decode.ops import (POOL_DTYPES, Q_DTYPES,
                                                      check_paged,
                                                      check_split,
                                                      split_workspace)
from repro_torch.kernels.paged_gqa_verify.ref import paged_gqa_verify_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.register(build.CudaKernel(
    "paged_gqa_verify", "paged_gqa_verify", "paged_gqa_verify_fwd",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
     ctypes.c_float, _I, _I, _I, _P]))


def check_verify(q, k_pages, v_pages, page_table, base_lens):
    """The verify kernel's shapes, types and limits: q (B, V, H, d), then
    `check_paged`'s for one window row and pool types of `POOL_DTYPES`.
    Any V x group query rows per KV head (they run in row chunks). Returns
    (B, H, K, d, ps, P, N), V and the int32 table and base lengths."""
    if q.dim() != 4:
        raise ValueError(f"paged_gqa_verify: q must be (B, V, H, d), got "
                         f"{tuple(q.shape)}")
    dims, table, lens = check_paged("paged_gqa_verify", q[:, 0], k_pages,
                                    v_pages, page_table, base_lens)
    if k_pages.dtype not in POOL_DTYPES:
        raise TypeError(f"paged_gqa_verify: pools must be float32, bfloat16, "
                        f"float16 or fp8 codes, got {k_pages.dtype}")
    check_split("paged_gqa_verify", k_pages, v_pages)
    return dims, q.shape[1], table, lens


def paged_gqa_verify(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, page_table: torch.Tensor,
                     base_lens: torch.Tensor) -> torch.Tensor:
    """q: (B, V, H, d) float32/bfloat16, V = speculate_k + 1 window rows
    per slot, row v at absolute position base_lens + v; k_pages, v_pages:
    (N, K, ps, d) float32, bfloat16, float16 or fp8 E4M3 codes (uint8);
    page_table: (B, P) int32 page ids; base_lens: (B,) int32 context lengths
    before the window. -> (B, V, H, d) in q's dtype; row v attends
    base_lens + v + 1 tokens (clamped to the table).

    On the card row v is, bit for bit, `paged_gqa_decode` at
    base_lens + v + 1 (`paged_gqa_verify_split_ref` repeats the
    arithmetic), with the same head dims and alignment."""
    if q.device.type != "cuda":
        return paged_gqa_verify_ref(q, k_pages, v_pages, page_table,
                                    base_lens)
    dims, V, table, lens = check_verify(q, k_pages, v_pages, page_table,
                                        base_lens)
    B, H, K, d, ps, P, N = dims
    q = q.contiguous()
    out = torch.empty_like(q)
    nsplit, work = split_workspace(q, dims, V * (H // K))
    KERNEL(build.ptr(q), build.ptr(k_pages), build.ptr(v_pages),
           build.ptr(table), build.ptr(lens), build.ptr(out), build.ptr(work),
           B, V, H, K, d, ps, P, N, 1.0 / math.sqrt(d), Q_DTYPES[q.dtype],
           POOL_DTYPES[k_pages.dtype], nsplit, build.stream_ptr(q))
    return out
