"""Prefill attention, causal or not: hand-written CUDA kernels on the card,
the plain version on the CPU.

Replaces the reference's prefill attention: the Pallas
`flash_attention_kernel` (`repro/kernels/flash_attention/kernel.py`) and
the jnp `blocked_attention` the reference prefill runs
(`repro/models/attention.py`), which compute the same function, causal (the
decoder's prefill) or not (`causal=False`: the encoder, and cross attention
over the encoder memory). Unlike the Pallas kernel (which asserts S % block
== 0) it takes ragged lengths by masking, and a query offset (`q_offset`,
the reference's `blocked_attention(..., q_offset=m)`) for the suffix rows
of a shared or chunked prefill. Source: `csrc/flash_attention.cu`, which
holds two kernels."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import LOG2E, flash_attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
# head dims the bf16 tensor-core kernel is built for
TC_HEAD_DIMS = (64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = build.register(build.CudaKernel(
    "flash_attention", "flash_attention", "flash_attention_fwd",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I,
     _I, _P]))


def variant(q: torch.Tensor) -> str:
    """Which kernel `flash_attention` launches for this query on the card:
    "tensor-core" for bf16 with head dim 64 or 128, else "cuda-core"."""
    tc = q.dtype == torch.bfloat16 and q.shape[-1] in TC_HEAD_DIMS
    return "tensor-core" if tc else "cuda-core"


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """`x` contiguous at a 16-byte aligned address (the tensor-core
    kernel's 16-byte copies need it; a view at an odd offset is copied)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0, causal: bool = True) -> torch.Tensor:
    """Attention. q: (B, S, H, h); k, v: (B, T, K, h), H % K == 0. Causal:
    query row s sits at absolute position q_offset + s and attends keys
    t <= q_offset + s (T >= q_offset + S in the shared prefill, whose keys
    are the m = q_offset cached rows followed by the S suffix rows). Not
    causal (`causal=False`, q_offset 0): every row attends all T keys, for
    any S and T (the encoder; cross attention over the encoder memory), no
    key tile skipped. Returns (B, S, H, h) in q's dtype.

    The kernels walk key tiles from key 0 whatever the offset, so rows at
    offset m equal rows m.. of the offset-0 call over the same keys, bit
    for bit, and keys past a row's diagonal (zero padding included) never
    change it.

    On the card the kernel is chosen by dtype and head dim (`variant`):
    bf16 with h in {64, 128} runs the tensor-core kernel (`mma.sync` bf16
    tiles, float32 softmax and accumulators, P rounded to bf16 for P·V);
    float32, and bf16 with any other h <= 128, run the CUDA-core kernel in
    float32. Nothing falls back to PyTorch: a refused launch raises. On
    the CPU it runs `flash_attention_ref`."""
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if q_offset and not causal:
        raise ValueError("q_offset applies to causal attention only")
    if q.device.type != "cuda":
        return flash_attention_ref(q, k, v, q_offset, causal)
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
    tc = variant(q) == "tensor-core"
    if tc:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        scale = LOG2E / math.sqrt(d)
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    KERNEL(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), B, S, T,
           H, K, d, int(q_offset), int(causal), scale, DTYPES[q.dtype],
           int(tc), build.stream_ptr(q))
    return out
