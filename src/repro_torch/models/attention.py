"""Attention pieces of the port (reference: `repro/models/attention.py`).

Full attention runs in the hand-written kernels: `kernels.flash_attention`
for prefill (causal), for the encoder and for cross attention over the
encoder memory (not causal), `kernels.paged_gqa_decode` and
`kernels.paged_gqa_verify` on paged caches, `kernels.gqa_decode` on the
dense decode cache, the ring caches of sliding-window ("local") and
chunked layers included. The prefill of local and chunked layers is plain
PyTorch, as the reference's is jnp (`local_attention`,
`chunked_attention`). The training losses run `blocked_attention`, the
plain differentiable version of kernel 2, on every device: the
reference's loss runs jnp `blocked_attention` too, and the port has no
backward kernel yet. The Q/K/V/O projections are plain matrix products."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.gqa_decode import gqa_decode
from repro_torch.models.meshctx import constrain

NEG_INF = -1.0e30


def project_qkv(cfg, p: dict, xq: torch.Tensor, xkv: torch.Tensor):
    """(B,S,D)->(B,S,H,h) and (B,T,D)->(B,T,K,h), with the QKV bias of
    configs that carry one (dsr1d-qwen)."""
    B, S, _ = xq.shape
    T = xkv.shape[1]
    dt = xq.dtype
    q = xq @ p["wq"].to(dt)
    k = xkv @ p["wk"].to(dt)
    v = xkv @ p["wv"].to(dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _constrain_chunks(qc, kc, vc):
    """The reference's sharding of windowed attention under a mesh: query
    rows within each chunk over "model", the (GQA-small) K/V replicated,
    the batch over ("pod", "data") (`meshctx.constrain`: no-ops without a
    mesh or on plain tensors)."""
    bspec = ("pod", "data")
    return (constrain(qc, (bspec, None, "model", None, None, None)),
            constrain(kc, (bspec, None, None, None, None)),
            constrain(vc, (bspec, None, None, None, None)))


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: int) -> torch.Tensor:
    """llama4's chunked attention: causal attention within chunks of
    `window` positions. q: (B, S, H, h); k, v: (B, S, K, h); S must be a
    multiple of min(window, S), as the reference asserts."""
    B, S, H, h = q.shape
    K = k.shape[2]
    G = H // K
    W = min(window, S)
    assert S % W == 0, (S, W)
    nc = S // W
    scale = 1.0 / torch.sqrt(torch.tensor(float(h)))
    qc = q.reshape(B, nc, W, K, G, h).float() * scale
    kc = k.reshape(B, nc, W, K, h).float()
    vc = v.reshape(B, nc, W, K, h).float()
    qc, kc, vc = _constrain_chunks(qc, kc, vc)
    s = torch.einsum("bcskgh,bctkh->bcskgt", qc, kc)
    causal = torch.tril(torch.ones((W, W), dtype=torch.bool,
                                   device=q.device))
    s = s.masked_fill(~causal[None, None, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bcskgt,bctkh->bcskgh", p, vc)
    return out.reshape(B, S, H, h).to(q.dtype)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int) -> torch.Tensor:
    """Sliding-window attention: each position sees itself and the
    `window` - 1 keys before it. q: (B, S, H, h); k, v: (B, S, K, h). Each
    chunk of W = min(window, S) queries attends its own chunk and the one
    before (S a multiple of W, as the reference asserts)."""
    B, S, H, h = q.shape
    K = k.shape[2]
    G = H // K
    W = min(window, S)
    assert S % W == 0, (S, W)
    nc = S // W
    scale = 1.0 / torch.sqrt(torch.tensor(float(h)))
    qc = q.reshape(B, nc, W, K, G, h).float() * scale
    kc = k.reshape(B, nc, W, K, h)
    vc = v.reshape(B, nc, W, K, h)
    qc, kc, vc = _constrain_chunks(qc, kc, vc)
    kprev = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    k2 = torch.cat([kprev, kc], dim=2).float()           # (B, nc, 2W, K, h)
    v2 = torch.cat([vprev, vc], dim=2).float()
    s = torch.einsum("bcskgh,bctkh->bcskgt", qc, k2)
    dev = q.device
    q_pos = torch.arange(W, device=dev)[:, None]           # within chunk
    kv_pos = torch.arange(2 * W, device=dev)[None, :] - W  # from chunk start
    valid = (q_pos >= kv_pos) & (q_pos - kv_pos < W)
    # chunk 0 has no previous chunk
    chunk_ok = torch.ones((nc, 1, 1), dtype=torch.bool, device=dev)
    chunk_ok[0] = False
    valid2 = valid[None] & (chunk_ok | (kv_pos >= 0)[None])
    s = s.masked_fill(~valid2[None, :, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bcskgt,bctkh->bcskgh", p, v2)
    return out.reshape(B, S, H, h).to(q.dtype)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """Full attention in plain PyTorch, which autograd differentiates, on
    any device: kernel 2's plain version (`flash_attention_ref`), the
    function of the reference's jnp `blocked_attention`. The training
    losses call it by name; serving runs kernel 2."""
    return flash_attention_ref(q, k, v, causal=causal)


def cross_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Attention without a mask: every query row attends all T rows. The
    encoder-decoder's cross attention over the memory and its encoder's
    self-attention. q: (B, S, H, h); k, v: (B, T, K, h), any S and T. The
    reference runs `blocked_attention(causal=False)`; the port runs kernel
    2 without its causal mask."""
    return flash_attention(q, k, v, causal=False)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, h); caches: (B, T, K, h); lengths: (B,) int32, each
    sequence's valid prefix: the row count of `decode_valid_mask`, whose
    valid slots are a prefix of the cache for every kind (a linear cache,
    and the rings of local and chunked layers alike). -> (B, 1, H, h) in
    q's dtype.

    The reference computes this with a jnp einsum over the valid mask; the
    port runs the same function through `kernels.gqa_decode` (the CUDA
    kernel on the card, its plain version on the CPU), handing it the
    (B, K, T, h) view of the cache without a copy. The softmax is over a
    set, so only the order of the sums differs from the masked einsum."""
    out = gqa_decode(q[:, 0], k_cache.transpose(1, 2),
                     v_cache.transpose(1, 2), lengths)
    return out[:, None]


def cache_write(cache_k: torch.Tensor, cache_v: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor, write_idx: int):
    """Write one K/V row per sequence at position `write_idx`, in place.

    cache_*: (B, T, K, h); k, v: (B, 1, K, h). As the reference's
    `jax.lax.dynamic_update_slice`, the index is clamped into [0, T - 1]:
    a write past the cache overwrites its last row."""
    idx = min(max(int(write_idx), 0), cache_k.shape[1] - 1)
    cache_k[:, idx] = k[:, 0].to(cache_k.dtype)
    cache_v[:, idx] = v[:, 0].to(cache_v.dtype)
    return cache_k, cache_v


def decode_valid_mask(kind: str, cache_len: int, pos: int, window: int = 0,
                      device=None) -> torch.Tensor:
    """Which cache slots a query at absolute position `pos` may attend:
    (cache_len,) bool.

    kind "full": a linear cache, slots [0, pos] valid (all of them once
    pos >= cache_len). kind "local": a ring of `window` slots holding the
    last W positions, min(pos + 1, W) of them valid. kind "chunked": a ring
    of `window` slots of which only the current chunk's (absolute positions
    >= pos - pos % W) are valid, pos % W + 1 of them. In every kind the
    valid slots are a prefix of the cache."""
    idx = torch.arange(cache_len, device=device)
    if kind == "full":
        return idx <= pos
    W = window
    assert cache_len == W, (cache_len, W)
    if kind == "local":
        return (idx <= pos) | (pos >= W)
    if kind == "chunked":
        return idx <= (pos % W)
    raise ValueError(kind)
