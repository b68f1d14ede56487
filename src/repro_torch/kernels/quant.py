"""Symmetric quantization helpers for the int8 matmul and the quantized KV
page pools (port of the reference's `repro/kernels/quant.py`, which imports
JAX, so the port keeps its own copy).

The write paths (prefill scatter, decode row append) and the read paths
(plain attention, the CUDA decode kernels) share these functions, so a pool
is quantized the same way wherever it is written.

Two storage formats:

  * int8 — symmetric per-row scales: each (token row, KV head) keeps a
    float32 scale ``s = max(|x|, eps) / 127`` beside its int8 payload. The
    division is a true division and `torch.round` rounds half to even, as
    `jnp.round` does, so codes and scales equal the reference's bit for bit
    on equal inputs.
  * fp8 (E4M3) — scale-free, 1 byte per element. Pools hold the E4M3 bit
    patterns as `torch.uint8` codes (the reference's `FP8_STORAGE_DTYPE`),
    so a pool compares byte for byte with the reference's and a kernel tells
    an fp8 pool from a float pool by its dtype. E4M3 has no infinity and
    overflows to NaN, so the cast clips to the finite range (+-448) first.

`kv_dtype_spec` maps a serving-level kv_dtype name to (pool dtype, bytes per
element, scale bytes per row), which `serve.paged.page_bytes` prices pages
with.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

INT8_QMAX = 127.0
SCALE_EPS = 1e-8
FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0
FP8_STORAGE_DTYPE = torch.uint8


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8 quantization: x ~= q * s (s keeps dims). The
    arithmetic stays in x's dtype, as in the reference."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(amax, min=SCALE_EPS) / INT8_QMAX
    q = torch.clamp(torch.round(x / s), -INT8_QMAX, INT8_QMAX).to(torch.int8)
    return q, s.float()


def quantize_cols(w: torch.Tensor):
    """Symmetric per-column int8 quantization: w ~= q * s."""
    amax = w.abs().amax(dim=0, keepdim=True)
    s = torch.clamp(amax, min=SCALE_EPS) / INT8_QMAX
    q = torch.clamp(torch.round(w / s), -INT8_QMAX, INT8_QMAX).to(torch.int8)
    return q, s.float()


def quantize_page_rows(x: torch.Tensor):
    """Per-row int8 for page pools: (..., rows, d) -> q (..., rows, d) int8
    and s (..., rows) float32, one scale per row (the last axis is the
    quantization group). Rows are cast to float32 first."""
    x = x.float()
    amax = x.abs().amax(dim=-1)
    s = torch.clamp(amax, min=SCALE_EPS) / INT8_QMAX
    q = torch.clamp(torch.round(x / s[..., None]),
                    -INT8_QMAX, INT8_QMAX).to(torch.int8)
    return q, s


def dequantize_page_rows(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Inverse of `quantize_page_rows`: q (..., rows, d), s (..., rows)."""
    return q.float() * s[..., None].float()


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """Saturating cast to E4M3 (values beyond +-448 clip, never NaN)."""
    return torch.clamp(x.float(), -FP8_MAX, FP8_MAX).to(FP8_DTYPE)


def is_fp8_pool(dtype) -> bool:
    """True for a KV pool holding E4M3 codes (stored uint8 or native fp8)."""
    return dtype in (FP8_STORAGE_DTYPE, FP8_DTYPE)


def to_fp8_codes(x: torch.Tensor) -> torch.Tensor:
    """Saturating E4M3 cast, returned as uint8 storage codes."""
    return to_fp8(x).view(FP8_STORAGE_DTYPE)


@functools.lru_cache(maxsize=None)
def fp8_table() -> torch.Tensor:
    """float32 value of each of the 256 E4M3 codes, decoded from the bits:
    sign, 4 exponent bits (bias 7), 3 mantissa bits; exponent 0 is
    subnormal (m * 2**-9) and code 0x7F/0xFF is NaN. The CUDA decode kernel
    (`csrc/paged_gqa_decode.cu`, `e4m3_to_f32`) decodes the same way."""
    c = np.arange(256)
    e, m = (c >> 3) & 0xF, c & 0x7
    mag = np.where(e == 0, m * 2.0**-9, (1.0 + m / 8.0) * 2.0**(e - 7.0))
    mag = np.where((e == 15) & (m == 7), np.nan, mag)
    val = np.where(c & 0x80, -mag, mag).astype(np.float32)
    return torch.from_numpy(val)


def from_fp8(x: torch.Tensor) -> torch.Tensor:
    """E4M3 (float8 values or uint8 codes) -> float32 by 256-entry table
    lookup, equal to the reference's `from_fp8`."""
    codes = x if x.dtype == FP8_STORAGE_DTYPE else x.view(FP8_STORAGE_DTYPE)
    return fp8_table().to(x.device)[codes.long()]


@dataclasses.dataclass(frozen=True)
class KVDtypeSpec:
    """Resolved kv_dtype: pool storage dtype plus physical byte accounting."""
    name: str
    pool_dtype: torch.dtype
    itemsize: int                 # payload bytes per cached element
    scale_bytes_per_row: int      # extra bytes per (token row, kv head)
    quantized: bool

    @property
    def has_scales(self) -> bool:
        return self.scale_bytes_per_row > 0


_FLOAT_KV_DTYPES = {
    "fp32": torch.float32,
    "bf16": torch.bfloat16,
    "fp16": torch.float16,
}


def kv_dtype_spec(name: str, native: Optional[torch.dtype] = None
                  ) -> KVDtypeSpec:
    """Resolve a serving-level kv_dtype name.

    "native" stores pages in `native` (the model compute dtype);
    "fp32"/"bf16"/"fp16" force a float pool dtype; "int8" selects
    per-row-scale int8 pools; "fp8" selects scale-free E4M3 code pools."""
    if name == "native":
        if native is None:
            raise ValueError("kv_dtype='native' needs the model dtype")
        return KVDtypeSpec("native", native, native.itemsize, 0, False)
    if name in _FLOAT_KV_DTYPES:
        dt = _FLOAT_KV_DTYPES[name]
        return KVDtypeSpec(name, dt, dt.itemsize, 0, False)
    if name == "int8":
        return KVDtypeSpec("int8", torch.int8, 1, 4, True)
    if name == "fp8":
        return KVDtypeSpec("fp8", FP8_STORAGE_DTYPE, 1, 0, True)
    raise ValueError(f"unknown kv_dtype {name!r} (want native/fp32/bf16/"
                     f"fp16/int8/fp8)")


def kv_dtype_bytes(name: str, native: Optional[torch.dtype] = None) -> int:
    """Payload bytes per element for a kv_dtype name."""
    return kv_dtype_spec(name, native).itemsize
