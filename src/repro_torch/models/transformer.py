"""Decoder-only LM of the port, for every decoder family the reference
serves: dense and MoE full attention (dsr1d-qwen, gpt2-xl, olmoe), chunked
and full attention with MoE (llama4-scout), sliding-window attention with
RG-LRU blocks (recurrentgemma), SSD blocks (mamba2) and the VLM prefix
(internvl2); port of the serving entry points of the reference's
`repro/models/transformer.py`:

    loss(params, batch)                        — training loss (+ MoE aux)
    prefill(params, batch, cache_len)          — prompt forward + dense cache
    init_cache(cfg, batch, cache_len)          — dense decode cache
    cache_specs(cfg, batch, cache_len, mesh)   — its sharding specs
    decode_step(params, cache, tokens)         — one token, dense cache
    init_paged_cache(..., kv_dtype)            — per-layer page pools
    write_prefill_to_pages(cfg, paged, dense, slot, page_ids)
    decode_step_paged(params, cache, tokens)   — one token per slot
    verify_step_paged(params, cache, tokens)   — a speculative window
    self_spec_draft(model, params, skip)       — layer-skipping draft
    prefill_shared(params, batch, prefix)      — suffix-only prefill
    gather_prefix_pages, prefix_tail_rows, write_shared_prefill_to_pages,
    copy_pages                                 — prefix sharing's page verbs

Parameters keep the reference's tree (`repro_torch.params`): one stacked
block dict per slot of the config's block pattern (a leading repetition
axis), then the unstacked `tail` blocks; layer r * len(pattern) + i is
repetition r of slot i. Caches follow the same layout ("slots" stacked,
"tail" unstacked). Full-attention prefill runs the hand-written flash
kernel where the reference runs jnp `blocked_attention` (the shared prefill
too, through the kernel's query offset); sliding-window and chunked
prefill are plain PyTorch, as the reference's are jnp. Paged decode runs
the paged GQA kernel, verification the paged verify kernel, and dense
decode the dense GQA decode kernel (where the reference runs a jnp
einsum), for full-attention caches and the ring caches of local and
chunked layers alike. RG-LRU and SSD blocks, and the MoE FFN, are plain
PyTorch (`models/{rglru,ssm,moe}.py`), as the reference's are jnp. All
kernels dispatch on the tensors' device: the CUDA kernel on the card, the
plain PyTorch version on the CPU. Pages hold the model dtype, another
float dtype, fp8 E4M3 codes (uint8) or int8 with per-row float32 scales
(`kv_dtype`, as in the reference); recurrent state stays dense per slot
beside them.

Unlike the reference's immutable arrays, caches are updated in place:
`write_prefill_to_pages`, `write_shared_prefill_to_pages`, `copy_pages`,
`decode_step_paged`, `verify_step_paged` and `decode_step` write into the
pools / dense caches / recurrent states and the position, table and
liveness tensors they are given.

On the card `decode_step_paged` replays one CUDA graph of the step's
whole body, `paged_decode_step` (`models/paged_graph.py`).

While a torch profiler runs, `prefill` and `prefill_shared`
(`model.prefill`), `decode_step_paged` (`model.decode_step`) and the
attention and FFN halves of their blocks (`model.attn`, `model.ffn`)
record host spans (`obs.host_spans`); a graphed decode step's blocks
record theirs only in the calls that run the body (its warm-up and
capture), not in replays.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import require_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_gqa_decode import (paged_gqa_decode,
                                                  paged_gqa_decode_quant)
from repro_torch.kernels.paged_gqa_verify import paged_gqa_verify
from repro_torch.kernels.quant import (FP8_STORAGE_DTYPE,
                                       dequantize_page_rows, from_fp8,
                                       kv_dtype_spec, quantize_page_rows,
                                       to_fp8_codes)
from repro_torch.models.attention import (blocked_attention, cache_write,
                                          chunked_attention,
                                          decode_attention,
                                          decode_valid_mask,
                                          local_attention, project_qkv)
from repro_torch.models.common import (apply_norm, apply_rope,
                                       checkpointed, cross_entropy,
                                       embed_tokens, lm_logits)
from repro_torch.models.ffn import apply_ffn
from repro_torch.models.moe import apply_moe
from repro_torch.models.paged_graph import StepCounts, StepGraph, layout_key
from repro_torch.models.rglru import (apply_rglru, apply_rglru_decode,
                                      init_rglru_cache, rglru_prefill)
from repro_torch.models.ssm import (apply_ssm, apply_ssm_decode,
                                    init_ssm_cache, ssm_prefill)
from repro_torch.obs.host_spans import host_span
from repro_torch.params import require_decoder

# Page 0 is the null page: retired/inactive slots point their whole table at
# it, so their masked lanes write and read harmless garbage.
PAGED_NULL_PAGE = 0
ATTENTION_KINDS = ("full", "local", "chunked")


def layer(blocks: dict, i: int) -> dict:
    """The parameters of layer `i` of a stacked block tree (views)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def tail_kinds(cfg) -> List[str]:
    """The kinds of the unstacked layers past the last whole repetition of
    the block pattern (recurrentgemma's 26 = 3 x 8 + 2)."""
    n_rep = cfg.num_layers // len(cfg.block_pattern)
    return list(cfg.layer_kinds()[n_rep * len(cfg.block_pattern):])


def _entry(tree: dict, r: Optional[int]) -> dict:
    """Repetition `r` of a stacked cache entry (views), or the unstacked
    entry itself (r None)."""
    return tree if r is None else {k: v[r] for k, v in tree.items()}


def stack_layers(cfg, params: dict, cache: Optional[dict] = None):
    """The layers in depth order as (kind, params, cache entry or None):
    every repetition of the pattern's slots, then the tail. Params and
    cache entries are views into the stacked trees."""
    pat = cfg.block_pattern
    n_rep = cfg.num_layers // len(pat)
    out = []
    for r in range(n_rep):
        for i, kind in enumerate(pat):
            out.append((kind, layer(params["blocks"][i], r),
                        None if cache is None
                        else _entry(cache["slots"][i], r)))
    for j, kind in enumerate(tail_kinds(cfg)):
        out.append((kind, params["tail"][j],
                    None if cache is None else cache["tail"][j]))
    return out


def _ffn_residual(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x + FFN(norm2(x)); the FFN is the MoE of MoE configs (its aux loss
    is a training term, dropped here as the reference's serving paths
    drop it)."""
    y = apply_norm(cfg, p["norm2"], x)
    if cfg.moe is not None:
        return x + apply_moe(cfg, p["ffn"], y)[0]
    return x + apply_ffn(cfg, p["ffn"], y)


def _attend(cfg, kind: str, p: dict, x: torch.Tensor,
            positions: torch.Tensor, full_attention=flash_attention):
    """x + attention(norm1(x)) over the whole sequence; returns (x, (k, v))
    with k, v (B, S, K, h) post-RoPE. Full attention runs `full_attention`
    (the prefill kernel when serving, `blocked_attention` in the loss);
    local and chunked attention the plain versions."""
    B, S, _ = x.shape
    y = apply_norm(cfg, p["norm1"], x)
    q, k, v = project_qkv(cfg, p["attn"], y, y)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if kind == "full":
        o = full_attention(q, k, v)
    elif kind == "local":
        o = local_attention(q, k, v, cfg.local_window)
    else:
        o = chunked_attention(q, k, v, cfg.local_window)
    x = x + o.reshape(B, S, cfg.q_dim) @ p["attn"]["wo"].to(x.dtype)
    return x, (k, v)


def _block_prefill(cfg, kind: str, p: dict, x: torch.Tensor,
                   positions: torch.Tensor):
    """One attention block over the whole prompt; returns (x_out, (k, v))
    with k, v (B, S, K, h) post-RoPE."""
    with host_span("model.attn"):
        x, kv = _attend(cfg, kind, p, x, positions)
    with host_span("model.ffn"):
        return _ffn_residual(cfg, p, x), kv


def _block_train(cfg, kind: str, p: dict, x: torch.Tensor,
                 positions: torch.Tensor):
    """One block of the training forward (the reference's `apply_block`):
    returns (x_out, the MoE aux loss, 0.0 for every other block). Full
    attention runs `blocked_attention`, the plain differentiable version
    of kernel 2, chosen here by name: the reference's loss runs jnp
    attention, and the port has no backward kernel for kernel 2 yet."""
    if kind in ATTENTION_KINDS:
        x, _ = _attend(cfg, kind, p, x, positions, blocked_attention)
        y = apply_norm(cfg, p["norm2"], x)
        if cfg.moe is not None:
            f, aux = apply_moe(cfg, p["ffn"], y)
            return x + f, aux
        return x + apply_ffn(cfg, p["ffn"], y), 0.0
    y = apply_norm(cfg, p["norm1"], x)
    if kind == "rglru":
        x = x + apply_rglru(cfg, p["rec"], y)
        return x + apply_ffn(cfg, p["ffn"], apply_norm(cfg, p["norm2"],
                                                       x)), 0.0
    return x + apply_ssm(cfg, p["ssm"], y), 0.0


def _recurrent_prefill(cfg, kind: str, p: dict, x: torch.Tensor):
    """An RG-LRU or SSD block over the whole prompt; returns (x_out, its
    final state: the recurrent state and the conv buffers)."""
    y = apply_norm(cfg, p["norm1"], x)
    if kind == "rglru":
        h, final = rglru_prefill(cfg, p["rec"], y)
        return _ffn_residual(cfg, p, x + h), final
    h, final = ssm_prefill(cfg, p["ssm"], y)
    return x + h, final


def _pool_cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """Cast KV rows to a pool dtype. fp8 pools store E4M3 bit codes in
    uint8, and the cast saturates because E4M3 overflows to NaN, not inf."""
    if dtype == FP8_STORAGE_DTYPE:
        return to_fp8_codes(x)
    return x.to(dtype)


def _block_decode_paged(cfg, p: dict, x: torch.Tensor, pools: dict,
                        pos: torch.Tensor,
                        page_table: torch.Tensor) -> torch.Tensor:
    """Paged decode block. x: (B, 1, D); pools: this layer's "kp"/"vp"
    (N, K, ps, h), plus "ks"/"vs" (N, K, ps) scales for int8 pages, written
    in place; pos: (B,) true per-slot positions."""
    with host_span("model.attn"):
        x = _attend_decode_paged(cfg, p, x, pools, pos, page_table)
    with host_span("model.ffn"):
        return _ffn_residual(cfg, p, x)


def _attend_decode_paged(cfg, p: dict, x: torch.Tensor, pools: dict,
                         pos: torch.Tensor,
                         page_table: torch.Tensor) -> torch.Tensor:
    """x + attention(norm1(x)) of a paged decode block, appending each
    slot's K/V row to its page."""
    B = x.shape[0]
    y = apply_norm(cfg, p["norm1"], x)
    q, k, v = project_qkv(cfg, p["attn"], y, y)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
    kp, vp = pools["kp"], pools["vp"]
    ps = kp.shape[-2]
    P = page_table.shape[1]
    pidx = page_table[torch.arange(B, device=x.device),
                      (pos // ps).clamp(0, P - 1)].long()
    off = (pos % ps).long()
    if "ks" in pools:
        # int8 pages: quantize the appended row per (slot, KV head); per-row
        # scales keep the append local, rows already in the page keep their
        # codes and scales
        ks, vs = pools["ks"], pools["vs"]
        qk, sk = quantize_page_rows(k[:, 0].float())
        qv, sv = quantize_page_rows(v[:, 0].float())
        kp[pidx, :, off] = qk
        vp[pidx, :, off] = qv
        ks[pidx, :, off] = sk
        vs[pidx, :, off] = sv
        o = paged_gqa_decode_quant(q[:, 0], kp, vp, ks, vs, page_table,
                                   pos + 1)
    else:
        kp[pidx, :, off] = _pool_cast(k[:, 0], kp.dtype)
        vp[pidx, :, off] = _pool_cast(v[:, 0], vp.dtype)
        o = paged_gqa_decode(q[:, 0], kp, vp, page_table, pos + 1)
    return x + o.reshape(B, 1, cfg.q_dim) @ p["attn"]["wo"].to(x.dtype)


def _block_verify_paged(cfg, p: dict, x: torch.Tensor, pools: dict,
                        pos: torch.Tensor,
                        page_table: torch.Tensor) -> torch.Tensor:
    """Speculative-verification block. x: (B, V, D), the V = k + 1 window
    rows per slot; pools: this layer's "kp"/"vp", written in place; pos:
    (B,) context lengths before the window. Writes all V K/V rows through
    the page table at positions pos .. pos + V - 1 (page index clamped to
    the table, as the reference), then scores the whole window in one
    `paged_gqa_verify` call. Rows past the eventually accepted count are
    garbage the next round overwrites before reading."""
    if "ks" in pools:
        raise NotImplementedError(
            "speculative verification does not support int8 KV pages: "
            "per-row scales of rolled-back rows would need requant-stable "
            "rewrites; use native/fp16/bf16/fp8 kv_dtype")
    B, V = x.shape[:2]
    y = apply_norm(cfg, p["norm1"], x)
    q, k, v = project_qkv(cfg, p["attn"], y, y)
    positions = pos[:, None] + torch.arange(V, dtype=pos.dtype,
                                            device=pos.device)[None, :]
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    kp, vp = pools["kp"], pools["vp"]
    ps = kp.shape[-2]
    P = page_table.shape[1]
    pidx = page_table[torch.arange(B, device=x.device)[:, None],
                      (positions // ps).clamp(0, P - 1)].long()   # (B, V)
    off = (positions % ps).long()
    kp[pidx, :, off] = _pool_cast(k, kp.dtype)
    vp[pidx, :, off] = _pool_cast(v, vp.dtype)
    o = paged_gqa_verify(q, kp, vp, page_table, pos)
    x = x + o.reshape(B, V, cfg.q_dim) @ p["attn"]["wo"].to(x.dtype)
    return _ffn_residual(cfg, p, x)


def _block_decode(cfg, kind: str, p: dict, x: torch.Tensor, cache: dict,
                  pos: int, positions: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Dense decode of an attention block. x: (B, 1, D); cache: this
    layer's "k"/"v" (B, T, K, h), written in place at `pos` (clamped to
    T - 1) for a full layer, at `pos % T` for the ring of a local or
    chunked one; positions: (B, 1) the RoPE positions (all `pos`);
    lengths: (B,) the valid prefix of the cache to attend."""
    B = x.shape[0]
    y = apply_norm(cfg, p["norm1"], x)
    q, k, v = project_qkv(cfg, p["attn"], y, y)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    T = cache["k"].shape[1]
    widx = pos if kind == "full" else pos % T
    ck, cv = cache_write(cache["k"], cache["v"], k, v, widx)
    o = decode_attention(q, ck, cv, lengths)
    x = x + o.reshape(B, 1, cfg.q_dim) @ p["attn"]["wo"].to(x.dtype)
    return _ffn_residual(cfg, p, x)


def _recurrent_decode(cfg, kind: str, p: dict, x: torch.Tensor,
                      cache: dict) -> torch.Tensor:
    """Decode step of an RG-LRU or SSD block, batched over the cache's
    rows; the new state is copied into `cache` in place."""
    y = apply_norm(cfg, p["norm1"], x)
    if kind == "rglru":
        h, new = apply_rglru_decode(cfg, p["rec"], y, cache)
        x = _ffn_residual(cfg, p, x + h)
    else:
        h, new = apply_ssm_decode(cfg, p["ssm"], y, cache)
        x = x + h
    for key, val in new.items():
        cache[key].copy_(val)
    return x


def _slot_cache_len(cfg, kind: str, cache_len: int) -> int:
    if kind in ("local", "chunked"):
        return min(cfg.local_window, cache_len)
    return cache_len


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device="cuda") -> Dict[str, Any]:
    """Dense decode cache, as `prefill` returns it: one entry per pattern
    slot stacked over the repetitions, the unstacked tail entries, and the
    shared position. Attention layers hold K/V (batch, T, K, h), T the
    cache length (a ring of min(local_window, cache_len) rows for local
    and chunked layers); RG-LRU and SSD layers their recurrent state and
    conv buffers."""
    dev = require_device(device)
    pat = cfg.block_pattern
    n_rep = cfg.num_layers // len(pat)

    def slot(kind, stack: Optional[int]):
        lead = () if stack is None else (stack,)
        if kind in ATTENTION_KINDS:
            shape = lead + (batch, _slot_cache_len(cfg, kind, cache_len),
                            cfg.num_kv_heads, cfg.head_dim)
            return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev)}
        init = init_rglru_cache if kind == "rglru" else init_ssm_cache
        c = init(cfg, batch, dtype, dev)
        return {k: v.expand(lead + v.shape).clone() for k, v in c.items()}

    return {"slots": [slot(k, n_rep) for k in pat],
            "tail": [slot(k, None) for k in tail_kinds(cfg)],
            "pos": 0}


def cache_specs(cfg, batch: int, cache_len: int, mesh,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Spec tuples (`models.sharding`) for the dense decode cache, in the
    tree of `init_cache` ("pos" gets the empty spec). The reference's
    policy: the batch dim over "data"; KV tensors (..., B, T, K, h) also
    shard their KV heads over "model" when they divide, else the sequence
    (context parallelism: decode all-reduces only per-row softmax
    statistics), else head_dim, else the sequence over "data" when the
    batch could not take it; recurrent states shard their trailing width
    over "model". `mesh` is anything `sharding.mesh_axes` reads."""
    from repro_torch.models.sharding import mesh_axes
    sizes = mesh_axes(mesh)
    shapes = init_cache(cfg, batch, cache_len, dtype, device="meta")

    def ax_ok(name, d):
        return name in sizes and d % sizes[name] == 0

    def spec_of(leaf):
        if not isinstance(leaf, torch.Tensor):
            return ()
        shp = tuple(leaf.shape)
        spec = [None] * len(shp)
        # the batch dim: the first dim equal to `batch` (after the stack)
        bi = None
        for i in range(len(shp)):
            if shp[i] == batch and (i == 0 or shp[0] != batch):
                bi = i
                break
        if shp and shp[0] == batch:
            bi = 0
        if bi is not None and ax_ok("data", shp[bi]):
            spec[bi] = "data"
        if len(shp) >= 2 and leaf.dtype != torch.int32:
            if len(shp) >= 4 and shp[-2] == cfg.num_kv_heads \
                    and shp[-1] == cfg.head_dim:
                if ax_ok("model", shp[-2]):
                    spec[-2] = "model"
                elif ax_ok("model", shp[-3]):
                    spec[-3] = "model"     # sequence (context parallel)
                elif ax_ok("model", shp[-1]):
                    spec[-1] = "model"
                elif spec[bi] != "data" and ax_ok("data", shp[-3]):
                    spec[-3] = "data"      # seq when the batch can't shard
            elif ax_ok("model", shp[-1]):
                spec[-1] = "model"         # recurrent width
        return tuple(spec)

    return {"slots": [{k: spec_of(v) for k, v in e.items()}
                      for e in shapes["slots"]],
            "tail": [{k: spec_of(v) for k, v in e.items()}
                     for e in shapes["tail"]],
            "pos": spec_of(shapes["pos"])}


def init_paged_cache(cfg, num_slots: int, num_pages: int, page_size: int,
                     max_pages_per_slot: int, dtype=torch.bfloat16,
                     device="cuda", kv_dtype: Optional[str] = None
                     ) -> Dict[str, Any]:
    """Paged decode state: per-layer page pools ((n_rep, N, K, ps, h) per
    pattern slot) shared by all slots, one page-table row + true position +
    liveness flag per slot. Recurrent (SSD / RG-LRU) blocks keep their
    fixed-size per-slot state dense, batched over the slots: only
    attention KV grows with context, so only it is paged. Sliding-window
    and chunked layers are refused, as in the reference.

    `kv_dtype` selects the page storage (see `kernels.quant`): None or
    "native" keeps pages in `dtype`; "fp32"/"bf16"/"fp16" force a float
    dtype; "int8" adds per-row float32 scale pools "ks"/"vs"; "fp8" stores
    E4M3 codes as uint8. Recurrent state always stays in `dtype`."""
    require_decoder(cfg)
    pat = cfg.block_pattern
    if any(k in ("local", "chunked") for k in pat):
        raise NotImplementedError(
            "paged decode supports full-attention (+ssm/rglru) stacks; "
            "window-bounded layers gain nothing from paging")
    dev = require_device(device)
    spec = kv_dtype_spec(kv_dtype or "native", native=dtype)
    n_rep = cfg.num_layers // len(pat)

    def slot(kind, stack: Optional[int]):
        lead = () if stack is None else (stack,)
        if kind == "full":
            shape = lead + (num_pages, cfg.num_kv_heads, page_size,
                            cfg.head_dim)
            e = {"kp": torch.zeros(shape, dtype=spec.pool_dtype, device=dev),
                 "vp": torch.zeros(shape, dtype=spec.pool_dtype, device=dev)}
            if spec.has_scales:
                e["ks"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=dev)
                e["vs"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=dev)
            return e
        init = init_rglru_cache if kind == "rglru" else init_ssm_cache
        c = init(cfg, num_slots, dtype, dev)
        return {k: v.expand(lead + v.shape).clone() for k, v in c.items()}

    return {
        "slots": [slot(k, n_rep) for k in pat],
        "tail": [slot(k, None) for k in tail_kinds(cfg)],
        "pos": torch.zeros(num_slots, dtype=torch.int32, device=dev),
        "page_table": torch.full((num_slots, max_pages_per_slot),
                                 PAGED_NULL_PAGE, dtype=torch.int32,
                                 device=dev),
        "active": torch.zeros(num_slots, dtype=torch.bool, device=dev),
    }


def write_prefill_to_pages(cfg, paged: dict, dense: dict, slot: int,
                           page_ids: torch.Tensor) -> dict:
    """Admission: scatter a batch=1 dense prefill cache into slot `slot`'s
    freshly allocated pages (cast, fp8-encoded or int8-quantized per row to
    the pool's format), copy its recurrent state into the slot's row, and
    rewrite its table row, position and liveness, in place. The dense
    cache_len must equal len(page_ids) * page_size."""
    npg = len(page_ids)
    page_ids = page_ids.to(paged["page_table"].device)
    idx = page_ids.long()
    pat = cfg.block_pattern
    entries = ([(k, e, d, True) for k, e, d in
                zip(pat, paged["slots"], dense["slots"])]
               + [(k, e, d, False) for k, e, d in
                  zip(tail_kinds(cfg), paged["tail"], dense["tail"])])
    for kind, entry, d_entry, stacked in entries:
        if not stacked:              # treat as a stack of one (views)
            entry = {k: v[None] for k, v in entry.items()}
            d_entry = {k: v[None] for k, v in d_entry.items()}
        if kind != "full":           # recurrent state: the slot's row
            for key, st in entry.items():
                st[:, slot] = d_entry[key][:, 0].to(st.dtype)
            continue
        ps = entry["kp"].shape[-2]
        for pool, scales, x in ((entry["kp"], entry.get("ks"), d_entry["k"]),
                                (entry["vp"], entry.get("vs"), d_entry["v"])):
            n, _, T, K, h = x.shape          # (n, 1, npg * ps, K, h)
            pages = x.reshape(n, npg, ps, K, h).transpose(2, 3)
            if scales is not None:           # int8: quantize per row
                q8, s = quantize_page_rows(pages)
                pool[:, idx] = q8
                scales[:, idx] = s
            else:
                pool[:, idx] = _pool_cast(pages, pool.dtype)
    row = torch.full_like(paged["page_table"][slot], PAGED_NULL_PAGE)
    row[:npg] = page_ids.to(row.dtype)
    paged["page_table"][slot] = row
    paged["pos"][slot] = int(dense["pos"])
    paged["active"][slot] = True
    return paged


# ---------------------------------------------------------------------------
# Prefix sharing: gather / COW-write / page-copy verbs and the suffix prefill
# ---------------------------------------------------------------------------
#
# Shared pages are reached through the same page-table indirection as private
# ones, so sharing needs no decode-kernel change. The device-side verbs:
#   gather_prefix_pages            pages -> dense (L, 1, m, K, h) prefix KV
#   prefix_tail_rows               last j rows of a gathered prefix (the
#                                  partially matched page's valid rows)
#   write_shared_prefill_to_pages  head + suffix KV -> fresh pages; table row
#                                  = shared pages ++ fresh pages
#   copy_pages                     COW split: clone one page in every layer
# and DecoderLM.prefill_shared runs the suffix-only forward against the
# gathered prefix KV. All of it is for pure full-attention stacks: recurrent
# blocks carry position-mixed state that cannot be cut at a prefix boundary.

def _require_pure_full(cfg, what: str) -> None:
    if any(k != "full" for k in cfg.layer_kinds()):
        raise NotImplementedError(
            f"{what} requires a pure full-attention stack; "
            f"{cfg.name} mixes {set(cfg.layer_kinds())}")


def gather_prefix_pages(cfg, paged: dict, page_ids: torch.Tensor,
                        n_rows: int) -> dict:
    """Collect the first `n_rows` KV rows stored in `page_ids` (table order)
    as a dense prefix {"slots": [{"k", "v"}], "tail": []} with leaves
    (L, 1, n_rows, K, h). Rows come back exactly as stored (post-RoPE, pool
    dtype); int8 pools dequantize with their per-row scales and fp8 pools
    decode their E4M3 codes, both returning float32 rows."""
    _require_pure_full(cfg, "gather_prefix_pages")
    idx = torch.as_tensor(page_ids, device=paged["page_table"].device).long()

    def take(pool, spool):
        x = pool[:, idx]                                # (L, npg, K, ps, h)
        if spool is not None:
            x = dequantize_page_rows(x, spool[:, idx])
        elif pool.dtype == FP8_STORAGE_DTYPE:
            x = from_fp8(x)
        n, npg, K, ps, h = x.shape
        x = x.transpose(2, 3).reshape(n, npg * ps, K, h)
        return x[:, None, :n_rows]                      # (L, 1, rows, K, h)

    return {"slots": [{"k": take(e["kp"], e.get("ks")),
                       "v": take(e["vp"], e.get("vs"))}
                      for e in paged["slots"]],
            "tail": []}


def prefix_tail_rows(prefix: dict, j: int) -> dict:
    """Last `j` rows of a gathered prefix: the valid head of the boundary
    page a COW admission rewrites into its private copy (j == 0: empty)."""
    def cut(a):
        return a[:, :, a.shape[2] - j:]
    return {"slots": [{"k": cut(e["k"]), "v": cut(e["v"])}
                      for e in prefix["slots"]],
            "tail": []}


def write_shared_prefill_to_pages(cfg, paged: dict, suffix: dict, head: dict,
                                  slot: int, shared_ids: torch.Tensor,
                                  fresh_ids: torch.Tensor) -> dict:
    """Prefix-hit admission, in place: map `shared_ids` read-only into the
    slot's table, then write `head` (the j rows re-owned from the partially
    matched page) followed by `suffix` (the freshly computed suffix KV)
    page-aligned into `fresh_ids`. Sets pos = |shared| * ps + j + |suffix|
    and activates the slot. With empty `shared_ids`/`head` this is a plain
    paged admission of a full prefill. int8 pools requantize the written
    rows per row, which is idempotent for `head` rows dequantized from the
    donor's pages, so shared pages stay quantized and bit-stable."""
    _require_pure_full(cfg, "write_shared_prefill_to_pages")
    dev = paged["page_table"].device
    shared_ids = torch.as_tensor(shared_ids, dtype=torch.int32, device=dev)
    fresh_ids = torch.as_tensor(fresh_ids, dtype=torch.int32, device=dev)
    n_shared, npg_f = len(shared_ids), len(fresh_ids)
    idx = fresh_ids.long()
    for e, hd, sf in zip(paged["slots"], head["slots"], suffix["slots"]):
        ps = e["kp"].shape[-2]
        for pool, spool, head_x, suf_x in (
                (e["kp"], e.get("ks"), hd["k"], sf["k"]),
                (e["vp"], e.get("vs"), hd["v"], sf["v"])):
            quantized = spool is not None

            def cast(a):
                return a.float() if quantized else _pool_cast(a, pool.dtype)

            rows = torch.cat([cast(head_x[:, 0]), cast(suf_x[:, 0])], dim=1)
            n, r, K, h = rows.shape
            rows = F.pad(rows, (0, 0, 0, 0, 0, npg_f * ps - r))
            x = rows.reshape(n, npg_f, ps, K, h).transpose(2, 3)
            if quantized:
                q8, sc = quantize_page_rows(x)
                pool[:, idx] = q8
                spool[:, idx] = sc
            else:
                pool[:, idx] = x
    ps = paged["slots"][0]["kp"].shape[-2]
    j = head["slots"][0]["k"].shape[2]
    s_suf = suffix["slots"][0]["k"].shape[2]
    row = torch.full_like(paged["page_table"][slot], PAGED_NULL_PAGE)
    row[:n_shared] = shared_ids
    row[n_shared:n_shared + npg_f] = fresh_ids
    paged["page_table"][slot] = row
    paged["pos"][slot] = n_shared * ps + j + s_suf
    paged["active"][slot] = True
    return paged


def copy_pages(cfg, paged: dict, src: int, dst: int) -> dict:
    """COW split, in place: duplicate page `src` into `dst` in every layer
    pool. Quantized pools copy payload and per-row scales alike, so COW
    clones stay quantized bit for bit."""
    _require_pure_full(cfg, "copy_pages")
    for e in paged["slots"]:
        for a in e.values():
            a[:, dst] = a[:, src]
    return paged


def _block_shared_prefill(cfg, p: dict, x: torch.Tensor,
                          positions: torch.Tensor, pk: torch.Tensor,
                          pv: torch.Tensor, pad_to: Optional[int] = None):
    """Full-attention block over suffix rows against a cached prefix (the
    reference's `_apply_block_shared_prefill`).

    x: (1, S_suf, D) suffix activations; positions: (S_suf,) absolute
    positions m .. m + S_suf - 1; pk/pv: (1, m, K, h) prefix KV exactly as
    stored (post-RoPE). Attention runs over concat(prefix, suffix) keys
    through the prefill kernel with `q_offset = m`. Returns (x_out, (k, v))
    with the suffix's KV only.

    The reference zero-pads the keys to the fixed width `pad_to` (the
    slot's capacity) so that its jnp reduction tree, and with it a row's
    bits, does not depend on the key count: that is what makes a prefix
    hit's KV equal to the donor's. The port's kernel needs no padding for
    that: its key tiles always start at key 0, a masked score gives p = 0
    exactly, and tiles past a row's diagonal are never loaded, so a row's
    value does not depend on the key count beyond its own position. The
    keys are therefore not padded; `pad_to` is kept for the reference's
    signature and must cover m + S_suf."""
    m = pk.shape[1]
    y = apply_norm(cfg, p["norm1"], x)
    q, k, v = project_qkv(cfg, p["attn"], y, y)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    kk = torch.cat([pk.to(k.dtype), k], dim=1)
    vv = torch.cat([pv.to(v.dtype), v], dim=1)
    if pad_to is not None and pad_to < kk.shape[1]:
        raise ValueError(f"pad_to {pad_to} < {kk.shape[1]} keys")
    o = flash_attention(q, kk, vv, q_offset=m)
    x = x + o.reshape(*x.shape[:2], cfg.q_dim) @ p["attn"]["wo"].to(x.dtype)
    return _ffn_residual(cfg, p, x), (k, v)


def paged_decode_step(cfg, dtype, params: dict, cache: dict,
                      tokens: torch.Tensor):
    """The body of `DecoderLM.decode_step_paged`, the function its CUDA
    graph captures: every op of one paged decode step in `dtype`, writing
    the pools and recurrent states in place and reading `cache`'s "pos",
    "page_table" and "active" without rebinding them. Returns (logits
    (num_slots, 1, V), pos + active)."""
    pos = cache["pos"]
    page_table = cache["page_table"]
    x = embed_tokens(cfg, params["embed"], tokens.long(), pos[:, None],
                     dtype)
    for kind, p, c in stack_layers(cfg, params, cache):
        if kind == "full":
            x = _block_decode_paged(cfg, p, x, c, pos, page_table)
        else:
            x = _recurrent_decode(cfg, kind, p, x, c)
    x = apply_norm(cfg, params["final_norm"], x)
    return (lm_logits(cfg, params["embed"], x),
            pos + cache["active"].to(pos.dtype))


@dataclass
class DecoderLM:
    """Decoder of any decoder-only config, computing in `compute_dtype` on
    `device` (the card unless the caller asks for the CPU). Encoder-decoder
    configs raise `NotImplementedError`. `remat` ("none", "full", "dots")
    is the loss's activation checkpointing (`models.common.checkpointed`);
    serving ignores it."""
    cfg: Any
    compute_dtype: torch.dtype = torch.bfloat16
    device: Any = "cuda"
    remat: str = "full"
    step_counts: StepCounts = field(default_factory=StepCounts, init=False,
                                    repr=False, compare=False)
    _step_graph: Optional[StepGraph] = field(default=None, init=False,
                                             repr=False, compare=False)

    def __post_init__(self):
        require_decoder(self.cfg)
        self.device = require_device(self.device)

    def _blocks(self, params: dict):
        """Per-layer params of a pure full-attention stack (one pattern
        slot, no tail)."""
        if params["tail"]:
            raise ValueError("pure full-attention stacks have no tail")
        blocks = params["blocks"][0]
        return [layer(blocks, i) for i in range(self.cfg.num_layers)]

    def _embed_inputs(self, params: dict, batch: dict):
        """tokens (+ the frontend's prefix embeds, through the projector)
        -> (x (B, S, D), positions (S,)). Token positions start after the
        n_pfx prefix rows, which take positions 0 .. n_pfx - 1."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        B, S_tok = tokens.shape
        n_pfx = 0
        if cfg.frontend is not None and "prefix_embeds" in batch:
            pfx = torch.as_tensor(batch["prefix_embeds"], device=self.device)
            n_pfx = pfx.shape[1]
        positions = torch.arange(n_pfx + S_tok, device=self.device)
        x = embed_tokens(cfg, params["embed"], tokens,
                         positions[n_pfx:][None].expand(B, S_tok),
                         self.compute_dtype)
        if n_pfx:
            dt = self.compute_dtype
            pr = pfx.to(dt) @ params["projector"]["w"].to(dt) \
                + params["projector"]["b"].to(dt)
            x = torch.cat([pr, x], dim=1)
        return x, positions

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Training loss (the reference's `DecoderLM.loss`): mean next-token
        cross entropy over batch["tokens"] (B, S) (labels default to the
        tokens; prefix rows are not scored) plus the MoE aux loss summed
        over the layers. Every block runs over the whole sequence, full
        attention through `blocked_attention` (see `_block_train`). Each
        repetition of the block pattern runs under `remat`, as the
        reference's scanned group does; the tail blocks run without."""
        cfg = self.cfg
        x, positions = self._embed_inputs(params, batch)
        layers = [(kind, p) for kind, p, _ in stack_layers(cfg, params)]
        width = len(cfg.block_pattern)
        n_grouped = cfg.num_layers // width * width

        def group(x, blocks):
            aux = torch.zeros((), dtype=torch.float32, device=self.device)
            for kind, p in blocks:
                x, a = _block_train(cfg, kind, p, x, positions)
                aux = aux + a
            return x, aux

        run = checkpointed(self.remat, group)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for r in range(0, n_grouped, width):
            x, a = run(x, layers[r:r + width])
            aux = aux + a
        for kind, p in layers[n_grouped:]:
            x, a = _block_train(cfg, kind, p, x, positions)
            aux = aux + a
        x = apply_norm(cfg, params["final_norm"], x)
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        n_pfx = x.shape[1] - tokens.shape[1]
        if n_pfx:
            x = x[:, n_pfx:, :]
        logits = lm_logits(cfg, params["embed"], x[:, :-1, :])
        labels = torch.as_tensor(batch.get("labels", batch["tokens"]),
                                 device=self.device).long()[:, 1:]
        return cross_entropy(logits, labels) + aux

    def prefill(self, params: dict, batch: dict, cache_len: int):
        """batch["tokens"]: (B, S) [+ "prefix_embeds" (B, n_pfx, D) for a
        config with a frontend]. Returns (last-position logits (B, 1, V),
        the dense cache of `init_cache` filled with the prompt: attention
        rows past S are zeros, a ring holds the last T positions at slots
        (S - T + i) % T, recurrent layers their final state, "pos" the
        prompt length)."""
        with host_span("model.prefill"):
            cfg = self.cfg
            x, positions = self._embed_inputs(params, batch)
            B, S, _ = x.shape
            if cache_len < S:
                raise ValueError(f"cache_len {cache_len} < prompt length "
                                 f"{S}")
            cache = init_cache(cfg, B, cache_len, self.compute_dtype,
                               self.device)
            for kind, p, c in stack_layers(cfg, params, cache):
                if kind in ATTENTION_KINDS:
                    x, (k, v) = _block_prefill(cfg, kind, p, x, positions)
                    T = c["k"].shape[1]
                    if kind == "full" or S <= T:
                        c["k"][:, :S] = k.to(c["k"].dtype)
                        c["v"][:, :S] = v.to(c["v"].dtype)
                    else:  # ring: the last T positions at (S - T + i) % T
                        idx = (S - T + torch.arange(T, device=self.device)
                               ) % T
                        c["k"][:, idx] = k[:, -T:].to(c["k"].dtype)
                        c["v"][:, idx] = v[:, -T:].to(c["v"].dtype)
                else:
                    x, final = _recurrent_prefill(cfg, kind, p, x)
                    for key, val in final.items():
                        c[key].copy_(val)
            cache["pos"] = S
            x = apply_norm(cfg, params["final_norm"], x)
            logits = lm_logits(cfg, params["embed"], x[:, -1:, :])
            return logits, cache

    def prefill_shared(self, params: dict, batch: dict, prefix: dict,
                       pad_to: Optional[int] = None):
        """Suffix-only prefill against a cached prompt prefix.

        batch["tokens"]: (1, S_suf), the prompt tokens after the matched
        prefix; `prefix`: the tree from `gather_prefix_pages` (per-layer
        post-RoPE KV of the matched m tokens). Embeds and ropes the suffix
        at absolute positions m .. m + S_suf - 1 and attends over the
        prefix's keys and its own, so only the suffix's compute is paid.
        Returns (last-position logits (1, 1, V), suffix KV {"slots":
        [{"k", "v": (L, 1, S_suf, K, h)}], "tail": []} for
        `write_shared_prefill_to_pages`). With an empty prefix (m == 0)
        this is a full prefill without the dense cache's padding. `pad_to`:
        see `_block_shared_prefill`. Pure full-attention stacks only."""
        with host_span("model.prefill"):
            cfg = self.cfg
            _require_pure_full(cfg, "prefill_shared")
            if "prefix_embeds" in batch:
                raise NotImplementedError("prefix caching is token-keyed; "
                                          "frontend prefix embeds unsupported")
            tokens = torch.as_tensor(batch["tokens"],
                                     device=self.device).long()
            B, S = tokens.shape
            m = prefix["slots"][0]["k"].shape[2]
            positions = m + torch.arange(S, device=self.device)
            x = embed_tokens(cfg, params["embed"], tokens,
                             positions[None].expand(B, S), self.compute_dtype)
            pk, pv = prefix["slots"][0]["k"], prefix["slots"][0]["v"]
            ks, vs = [], []
            for i, p in enumerate(self._blocks(params)):
                x, (k, v) = _block_shared_prefill(cfg, p, x, positions, pk[i],
                                                  pv[i], pad_to)
                ks.append(k)
                vs.append(v)
            x = apply_norm(cfg, params["final_norm"], x)
            logits = lm_logits(cfg, params["embed"], x[:, -1:, :])
            return logits, {"slots": [{"k": torch.stack(ks),
                                       "v": torch.stack(vs)}], "tail": []}

    def decode_step_paged(self, params: dict, cache: dict,
                          tokens: torch.Tensor):
        """tokens: (num_slots, 1) against an `init_paged_cache` state.
        Returns (logits (num_slots, 1, V), cache), the cache updated in
        place. Each slot embeds/ropes at its own `pos`, writes its K/V row
        through its page-table row, and attends over exactly `pos + 1`
        tokens; recurrent blocks step every slot's dense state. Inactive
        slots run masked (null page) and their `pos` does not advance.

        On the card the step replays one CUDA graph of
        `paged_decode_step` (`decode_step_static`); on the CPU it runs
        eagerly. `step_counts` counts both."""
        with host_span("model.decode_step"):
            if self.device.type == "cuda":
                return self.decode_step_static(params, cache, tokens)
            self.step_counts.eager += 1
            logits, cache["pos"] = paged_decode_step(
                self.cfg, self.compute_dtype, params, cache, tokens)
            return logits, cache

    def decode_step_static(self, params: dict, cache: dict,
                           tokens: torch.Tensor):
        """`decode_step_paged` through the buffers of a
        `paged_graph.StepGraph`: a replay of its CUDA graph on the card
        (after its warm-up calls), the body run eagerly on the same buffers
        elsewhere. One graph a model, captured again only when the layout
        of the parameters, pools or inputs changes."""
        key = layout_key(params, cache, tokens)
        if self._step_graph is None or self._step_graph.key != key:
            self._step_graph = StepGraph(key, cache, tokens)

        def step(c, t):
            return paged_decode_step(self.cfg, self.compute_dtype, params,
                                     c, t)
        return self._step_graph(step, cache, tokens, self.step_counts), cache

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """tokens: (B, 1) against a dense cache (`init_cache`, or the one
        `prefill` returns). Returns (logits (B, 1, V), cache), the cache
        updated in place: every attention layer writes its K/V row (at
        `pos` in a linear cache, at `pos % T` in a ring) and attends the
        rows `decode_valid_mask` allows, recurrent layers step their state,
        and `pos` advances by one. Past a linear cache (pos >= T) the write
        lands on row T - 1 and all T rows are attended, as the reference's
        clamped `dynamic_update_slice` does."""
        cfg = self.cfg
        pos = int(cache["pos"])
        B = tokens.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.long,
                               device=self.device)
        x = embed_tokens(cfg, params["embed"], tokens.long(), positions,
                         self.compute_dtype)
        lengths = {}
        for kind, p, c in stack_layers(cfg, params, cache):
            if kind not in ATTENTION_KINDS:
                x = _recurrent_decode(cfg, kind, p, x, c)
                continue
            T = c["k"].shape[1]
            if (kind, T) not in lengths:
                lengths[kind, T] = decode_valid_mask(
                    kind, T, pos, cfg.local_window, self.device).sum(
                    dtype=torch.int32).expand(B)
            x = _block_decode(cfg, kind, p, x, c, pos, positions,
                              lengths[kind, T])
        cache["pos"] = pos + 1
        x = apply_norm(cfg, params["final_norm"], x)
        return lm_logits(cfg, params["embed"], x), cache

    def verify_step_paged(self, params: dict, cache: dict,
                          tokens: torch.Tensor):
        """tokens: (num_slots, V), the pending token followed by the
        k = V - 1 drafted candidates, against an `init_paged_cache` state.
        Writes all V K/V rows at positions pos .. pos + V - 1 through the
        page table (in place) and scores the window with one
        `paged_gqa_verify` call per layer; logits[:, v] conditions on
        tokens[:, :v + 1]. Returns (logits (num_slots, V, vocab), cache).
        `pos` is not advanced: the speculative loop moves it by the
        accepted count, so a rejected suffix rolls back for free. Pure
        full-attention stacks only: recurrent state cannot un-consume a
        rejected token."""
        cfg = self.cfg
        _require_pure_full(cfg, "verify_step_paged")
        pos = cache["pos"]
        page_table = cache["page_table"]
        entry = cache["slots"][0]
        V = tokens.shape[1]
        positions = pos[:, None] + torch.arange(V, dtype=pos.dtype,
                                                device=pos.device)[None, :]
        x = embed_tokens(cfg, params["embed"], tokens.long(), positions,
                         self.compute_dtype)
        for i, p in enumerate(self._blocks(params)):
            x = _block_verify_paged(cfg, p, x,
                                    {k: v[i] for k, v in entry.items()}, pos,
                                    page_table)
        x = apply_norm(cfg, params["final_norm"], x)
        return lm_logits(cfg, params["embed"], x), cache


def self_spec_draft(model: DecoderLM, params: dict,
                    skip: int = 2) -> Tuple[DecoderLM, dict]:
    """Self-speculation draft: the target restricted to every `skip`-th
    layer, sharing the target's weights. The stacked block tensors are
    sliced along the layer axis as views (`a[::skip]`, no copy); the
    embedding, final norm and LM head are the target's. `skip=1` gives a
    draft whose greedy drafts always match the target, a 100%-acceptance
    oracle."""
    cfg = model.cfg
    if len(cfg.block_pattern) != 1:
        raise NotImplementedError(
            "self-speculation slices the stacked params of one pattern "
            f"slot; {cfg.name} has pattern {cfg.block_pattern}")
    if skip < 1:
        raise ValueError(f"skip must be >= 1, got {skip}")
    dcfg = dataclasses.replace(cfg, num_layers=len(range(0, cfg.num_layers,
                                                         skip)),
                               name=f"{cfg.name}-selfspec{skip}")

    def every(tree):
        return {k: every(v) if isinstance(v, dict) else v[::skip]
                for k, v in tree.items()}

    dparams = dict(params)
    dparams["blocks"] = [every(params["blocks"][0])]
    dparams["tail"] = []
    draft = DecoderLM(dcfg, compute_dtype=model.compute_dtype,
                      device=model.device)
    return draft, dparams
