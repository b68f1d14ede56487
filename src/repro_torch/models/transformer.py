"""Decoder-only LM of the port, for pure full-attention stacks
(`block_pattern == ("full",)`: dsr1d-qwen-1.5b and gpt2-xl); port of the
serving entry points of the reference's `repro/models/transformer.py`:

    prefill(params, batch, cache_len)          — prompt forward + dense KV
    init_cache(cfg, batch, cache_len)          — dense decode cache
    decode_step(params, cache, tokens)         — one token, dense cache
    init_paged_cache(..., kv_dtype)            — per-layer page pools
    write_prefill_to_pages(cfg, paged, dense, slot, page_ids)
    decode_step_paged(params, cache, tokens)   — one token per slot
    verify_step_paged(params, cache, tokens)   — a speculative window
    self_spec_draft(model, params, skip)       — layer-skipping draft
    prefill_shared(params, batch, prefix)      — suffix-only prefill
    gather_prefix_pages, prefix_tail_rows, write_shared_prefill_to_pages,
    copy_pages                                 — prefix sharing's page verbs

Parameters keep the reference's tree (`repro_torch.params`): the blocks of
the single pattern slot are stacked along a leading layer axis, and the
unstacked `tail` is empty for these configs. Prefill attention runs the
hand-written flash kernel where the reference runs jnp `blocked_attention`
(the shared prefill too, through the kernel's query offset);
paged decode runs the paged GQA kernel, verification the paged verify
kernel, and dense decode the dense GQA decode kernel (where the reference
runs a jnp einsum). All dispatch on the tensors' device: the CUDA kernel on
the card, the plain PyTorch version on the CPU. Pages hold the model dtype,
another float dtype, fp8 E4M3 codes (uint8) or int8 with per-row float32
scales (`kv_dtype`, as in the reference).

Unlike the reference's immutable arrays, caches are updated in place:
`write_prefill_to_pages`, `write_shared_prefill_to_pages`, `copy_pages`,
`decode_step_paged`, `verify_step_paged` and `decode_step` write into the
pools / dense caches and the position, table and liveness tensors they are
given.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

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
from repro_torch.models.attention import (cache_write, decode_attention,
                                          decode_valid_mask, project_qkv)
from repro_torch.models.common import (apply_norm, apply_rope, embed_tokens,
                                       lm_logits)
from repro_torch.models.ffn import apply_ffn

# Page 0 is the null page: retired/inactive slots point their whole table at
# it, so their masked lanes write and read harmless garbage.
PAGED_NULL_PAGE = 0


def require_full_attention(cfg) -> None:
    if tuple(cfg.block_pattern) != ("full",) or cfg.moe is not None \
            or cfg.frontend is not None or cfg.is_encdec:
        raise NotImplementedError(
            f"the port runs dense full-attention decoders only; {cfg.name} "
            f"has pattern {cfg.block_pattern}")


def layer(blocks: dict, i: int) -> dict:
    """The parameters of layer `i` of a stacked block tree (views)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def _ffn_residual(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    return x + apply_ffn(cfg, p["ffn"], apply_norm(cfg, p["norm2"], x))


def _block_prefill(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """One block over the whole prompt; returns (x_out, (k, v)) with k, v
    (B, S, K, h) post-RoPE."""
    B, S, _ = x.shape
    y = apply_norm(cfg, p["norm1"], x)
    q, k, v = project_qkv(cfg, p["attn"], y, y)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v).reshape(B, S, cfg.q_dim)
    x = x + o @ p["attn"]["wo"].to(x.dtype)
    return _ffn_residual(cfg, p, x), (k, v)


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
    x = x + o.reshape(B, 1, cfg.q_dim) @ p["attn"]["wo"].to(x.dtype)
    return _ffn_residual(cfg, p, x)


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


def _block_decode(cfg, p: dict, x: torch.Tensor, cache: dict, pos: int,
                  positions: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Dense decode block. x: (B, 1, D); cache: this layer's "k"/"v"
    (B, T, K, h), written in place at `pos` (clamped to T - 1); positions:
    (B, 1) the RoPE positions (all `pos`); lengths: (B,) rows to attend."""
    B = x.shape[0]
    y = apply_norm(cfg, p["norm1"], x)
    q, k, v = project_qkv(cfg, p["attn"], y, y)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    ck, cv = cache_write(cache["k"], cache["v"], k, v, pos)
    o = decode_attention(q, ck, cv, lengths)
    x = x + o.reshape(B, 1, cfg.q_dim) @ p["attn"]["wo"].to(x.dtype)
    return _ffn_residual(cfg, p, x)


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device="cuda") -> Dict[str, Any]:
    """Dense decode cache: per-layer K/V (stacked over the layers,
    (L, batch, cache_len, K, h)) and the shared position, as `prefill`
    returns it."""
    require_full_attention(cfg)
    dev = require_device(device)
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads,
             cfg.head_dim)
    return {"slots": [{"k": torch.zeros(shape, dtype=dtype, device=dev),
                       "v": torch.zeros(shape, dtype=dtype, device=dev)}],
            "pos": 0}


def init_paged_cache(cfg, num_slots: int, num_pages: int, page_size: int,
                     max_pages_per_slot: int, dtype=torch.bfloat16,
                     device="cuda", kv_dtype: Optional[str] = None
                     ) -> Dict[str, Any]:
    """Paged decode state: per-layer page pools (stacked over the layers,
    (L, N, K, ps, h)) shared by all slots, one page-table row + true
    position + liveness flag per slot.

    `kv_dtype` selects the page storage (see `kernels.quant`): None or
    "native" keeps pages in `dtype`; "fp32"/"bf16"/"fp16" force a float
    dtype; "int8" adds per-row float32 scale pools "ks"/"vs"
    (L, N, K, ps); "fp8" stores E4M3 codes as uint8."""
    require_full_attention(cfg)
    dev = require_device(device)
    spec = kv_dtype_spec(kv_dtype or "native", native=dtype)
    shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, page_size,
             cfg.head_dim)
    entry = {"kp": torch.zeros(shape, dtype=spec.pool_dtype, device=dev),
             "vp": torch.zeros(shape, dtype=spec.pool_dtype, device=dev)}
    if spec.has_scales:
        entry["ks"] = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
        entry["vs"] = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
    return {
        "slots": [entry],
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
    the pool's format) and rewrite its table row, position and liveness, in
    place. The dense cache_len must equal
    len(page_ids) * page_size."""
    npg = len(page_ids)
    page_ids = page_ids.to(paged["page_table"].device)
    idx = page_ids.long()
    for entry, d_entry in zip(paged["slots"], dense["slots"]):
        ps = entry["kp"].shape[-2]
        for pool, scales, x in ((entry["kp"], entry.get("ks"), d_entry["k"]),
                                (entry["vp"], entry.get("vs"), d_entry["v"])):
            n, _, T, K, h = x.shape          # (L, 1, npg * ps, K, h)
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


@dataclass
class DecoderLM:
    """Dense decoder for `block_pattern == ("full",)` configs, computing in
    `compute_dtype` on `device` (the card unless the caller asks for the
    CPU)."""
    cfg: Any
    compute_dtype: torch.dtype = torch.bfloat16
    device: Any = "cuda"

    def __post_init__(self):
        require_full_attention(self.cfg)
        self.device = require_device(self.device)

    def _blocks(self, params: dict):
        if params["tail"]:
            raise ValueError("pure full-attention stacks have no tail")
        blocks = params["blocks"][0]
        return [layer(blocks, i) for i in range(self.cfg.num_layers)]

    def prefill(self, params: dict, batch: dict, cache_len: int):
        """batch["tokens"]: (B, S). Returns (last-position logits (B, 1, V),
        dense cache {"slots": [{"k", "v": (L, B, cache_len, K, h)}],
        "pos": S}); rows past S are zeros, as in the reference."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        B, S = tokens.shape
        if cache_len < S:
            raise ValueError(f"cache_len {cache_len} < prompt length {S}")
        positions = torch.arange(S, device=self.device)
        x = embed_tokens(cfg, params["embed"], tokens,
                         positions[None].expand(B, S), self.compute_dtype)
        ks, vs = [], []
        for p in self._blocks(params):
            x, (k, v) = _block_prefill(cfg, p, x, positions)
            ks.append(k)
            vs.append(v)

        def dense(rows):
            out = torch.zeros((cfg.num_layers, B, cache_len,
                               cfg.num_kv_heads, cfg.head_dim),
                              dtype=self.compute_dtype, device=self.device)
            out[:, :, :S] = torch.stack(rows)
            return out

        x = apply_norm(cfg, params["final_norm"], x)
        logits = lm_logits(cfg, params["embed"], x[:, -1:, :])
        return logits, {"slots": [{"k": dense(ks), "v": dense(vs)}],
                        "pos": S}

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
        see `_block_shared_prefill`."""
        cfg = self.cfg
        _require_pure_full(cfg, "prefill_shared")
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
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
        tokens. Inactive slots run masked (null page) and their `pos` does
        not advance."""
        cfg = self.cfg
        pos = cache["pos"]
        page_table = cache["page_table"]
        entry = cache["slots"][0]
        x = embed_tokens(cfg, params["embed"], tokens.long(), pos[:, None],
                         self.compute_dtype)
        for i, p in enumerate(self._blocks(params)):
            x = _block_decode_paged(cfg, p, x,
                                    {k: v[i] for k, v in entry.items()}, pos,
                                    page_table)
        cache["pos"] = pos + cache["active"].to(pos.dtype)
        x = apply_norm(cfg, params["final_norm"], x)
        return lm_logits(cfg, params["embed"], x), cache

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """tokens: (B, 1) against a dense cache (`init_cache`, or the one
        `prefill` returns). Returns (logits (B, 1, V), cache), the cache
        updated in place: every sequence writes its K/V row at `pos` and
        attends the rows `decode_valid_mask("full", T, pos)` allows, and
        `pos` advances by one. Past the cache (pos >= T) the write lands on
        row T - 1 and all T rows are attended, as the reference's clamped
        `dynamic_update_slice` does."""
        cfg = self.cfg
        pos = int(cache["pos"])
        entry = cache["slots"][0]
        B = tokens.shape[0]
        T = entry["k"].shape[2]
        positions = torch.full((B, 1), pos, dtype=torch.long,
                               device=self.device)
        lengths = decode_valid_mask("full", T, pos, self.device).sum(
            dtype=torch.int32).expand(B)
        x = embed_tokens(cfg, params["embed"], tokens.long(), positions,
                         self.compute_dtype)
        for i, p in enumerate(self._blocks(params)):
            x = _block_decode(cfg, p, x, {k: v[i] for k, v in entry.items()},
                              pos, positions, lengths)
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
        accepted count, so a rejected suffix rolls back for free."""
        cfg = self.cfg
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
