"""Workload-graph builder: ArchConfig -> operation/tensor dependency graph for
the TRAPTI Stage-I simulator; a copy of the reference package's
`repro/core/workload.py`.

Follows the paper's conventions (Sec. IV-A):
  * one full forward (prefill) pass at sequence length M,
  * 8-bit quantized operands throughout,
  * positional-encoding ops omitted (element-wise, immaterial to SRAM trends),
  * `subops` decomposes large matmuls along the row (M) dimension so they can
    be scheduled across the systolic arrays (paper uses subops=4).

The builder is family-aware: dense/GQA attention (the paper's two workloads),
MoE, SSD (mamba2), RG-LRU, encoder-decoder and VLM-prefix graphs all lower to
the same op vocabulary {matmul, softmax, norm, elementwise}, which is what
makes the paper's Stage II applicable to every assigned architecture.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ArchConfig


@dataclass
class Tensor:
    tid: int
    name: str
    size: int                      # bytes
    kind: str                      # weight | activation | kv | score
    producer: Optional[int]        # op id; None => resident in DRAM (weights/inputs)
    consumers: List[int] = field(default_factory=list)


@dataclass
class Op:
    oid: int
    name: str
    op_type: str                   # matmul | softmax | norm | elementwise
    inputs: List[int]              # tensor ids
    output: int                    # tensor id
    macs: int = 0                  # multiply-accumulates (matmul)
    vector_ops: int = 0            # element ops (softmax/norm/elementwise)
    # matmul geometry (rows, contraction, cols) for SA-tiling time model
    mnk: Tuple[int, int, int] = (0, 0, 0)
    layer: int = -1
    tag: str = ""                  # coarse op class for Fig-6 style breakdowns


@dataclass
class WorkloadGraph:
    name: str
    ops: Dict[int, Op] = field(default_factory=dict)
    tensors: Dict[int, Tensor] = field(default_factory=dict)

    # ----------------------------------------------------------- builders
    def add_tensor(self, name: str, size: int, kind: str,
                   producer: Optional[int] = None) -> int:
        tid = len(self.tensors)
        self.tensors[tid] = Tensor(tid, name, int(size), kind, producer)
        return tid

    def add_op(self, name: str, op_type: str, inputs: List[int],
               out_name: str, out_size: int, out_kind: str = "activation",
               macs: int = 0, vector_ops: int = 0,
               mnk: Tuple[int, int, int] = (0, 0, 0), layer: int = -1,
               tag: str = "") -> Tuple[int, int]:
        oid = len(self.ops)
        out = self.add_tensor(out_name, out_size, out_kind, producer=oid)
        self.ops[oid] = Op(oid, name, op_type, list(inputs), out, int(macs),
                           int(vector_ops), mnk, layer, tag or op_type)
        for t in inputs:
            self.tensors[t].consumers.append(oid)
        return oid, out

    # ------------------------------------------------------------- stats
    def total_macs(self) -> int:
        return sum(op.macs for op in self.ops.values())

    def total_weight_bytes(self) -> int:
        return sum(t.size for t in self.tensors.values() if t.kind == "weight")


# ---------------------------------------------------------------------------
# Dense / GQA decoder-layer graph (the paper's workloads)
# ---------------------------------------------------------------------------

def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class _LayerBuilder:
    """Helper carrying common dims while emitting one layer's ops."""

    def __init__(self, g: WorkloadGraph, cfg: ArchConfig, M: int, subops: int,
                 byte: int, layer: int):
        self.g, self.cfg, self.M, self.subops = g, cfg, M, subops
        self.b = byte
        self.L = layer

    def weight(self, name: str, size: int) -> int:
        return self.g.add_tensor(f"L{self.L}.{name}", size * self.b, "weight")

    def matmul_rowsplit(self, name: str, x: int, w: int, rows: int, k: int,
                        cols: int, out_kind: str = "activation",
                        tag: str = "") -> List[int]:
        """Row-partitioned matmul (subops chunks along `rows`)."""
        outs = []
        n = self.subops
        chunk = _ceil_div(rows, n)
        for i in range(n):
            r = min(chunk, rows - i * chunk)
            if r <= 0:
                break
            _, out = self.g.add_op(
                f"L{self.L}.{name}.s{i}", "matmul", [x, w],
                f"L{self.L}.{name}.out{i}", r * cols * self.b, out_kind,
                macs=r * k * cols, mnk=(r, k, cols), layer=self.L,
                tag=tag or name)
            outs.append(out)
        return outs

    def vector(self, name: str, inputs: List[int], out_size: int,
               ops_per_el: int, op_type: str = "elementwise",
               out_kind: str = "activation", tag: str = "") -> int:
        _, out = self.g.add_op(
            f"L{self.L}.{name}", op_type, inputs,
            f"L{self.L}.{name}.out", out_size * self.b, out_kind,
            vector_ops=(out_size * ops_per_el), layer=self.L,
            tag=tag or name)
        return out


def _attention_ops(lb: _LayerBuilder, x: int, kind: str = "full") -> int:
    """Emit attention ops; returns output tensor id. x: (M, D) activation.

    Sub-op decomposition follows the paper's `subops` setting: projections and
    the output projection are split along the head dimension into weight
    *slices* (so weight slabs stream through SRAM instead of co-residing),
    and scores/AV are grouped by query heads aligned to their shared KV head
    (GQA-aware).
    """
    g, cfg, M, b, L = lb.g, lb.cfg, lb.M, lb.b, lb.L
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n = lb.subops

    # effective kv context per query for local/chunked variants
    if kind in ("local", "chunked") and cfg.local_window:
        ctx = min(cfg.local_window, M)
    else:
        ctx = M

    # query-head groups, contiguous, aligned to the GQA kv mapping
    per = _ceil_div(H, n)
    head_groups: List[Tuple[int, int]] = []       # (start_head, n_heads)
    s = 0
    while s < H:
        h = min(per, H - s)
        head_groups.append((s, h))
        s += h
    q_per_kv = max(1, H // max(K, 1))

    # KV slices: one per kv head group (at most `n` slices)
    n_kv = min(K, n)
    kv_per = _ceil_div(K, n_kv)
    kv_groups: List[Tuple[int, int]] = []
    s = 0
    while s < K:
        h = min(kv_per, K - s)
        kv_groups.append((s, h))
        s += h

    # --- projections: one sliced matmul per group ----------------------------
    q_slices = []
    for i, (hs, h) in enumerate(head_groups):
        wq = lb.weight(f"Wq.s{i}", D * h * hd)
        _, qo = g.add_op(
            f"L{L}.attn.q.s{i}", "matmul", [x, wq],
            f"L{L}.attn.q.out{i}", M * h * hd * b, "activation",
            macs=M * D * h * hd, mnk=(M, D, h * hd), layer=L, tag="attn.proj")
        q_slices.append(qo)
    k_slices, v_slices = [], []
    for i, (ks, kh) in enumerate(kv_groups):
        wk = lb.weight(f"Wk.s{i}", D * kh * hd)
        wv = lb.weight(f"Wv.s{i}", D * kh * hd)
        _, ko = g.add_op(
            f"L{L}.attn.k.s{i}", "matmul", [x, wk],
            f"L{L}.attn.k.out{i}", M * kh * hd * b, "kv",
            macs=M * D * kh * hd, mnk=(M, D, kh * hd), layer=L,
            tag="attn.proj")
        _, vo = g.add_op(
            f"L{L}.attn.v.s{i}", "matmul", [x, wv],
            f"L{L}.attn.v.out{i}", M * kh * hd * b, "kv",
            macs=M * D * kh * hd, mnk=(M, D, kh * hd), layer=L,
            tag="attn.proj")
        k_slices.append(ko)
        v_slices.append(vo)

    def kv_deps(hs: int, h: int) -> List[int]:
        """kv slice indices covering query heads [hs, hs+h)."""
        lo = (hs // q_per_kv) // kv_per
        hi = ((hs + h - 1) // q_per_kv) // kv_per
        return list(range(lo, min(hi, len(kv_groups) - 1) + 1))

    # --- scores / softmax / AV per head group ---------------------------------
    out_partials = []
    for i, (hs, h) in enumerate(head_groups):
        deps = kv_deps(hs, h)
        _, sc = g.add_op(
            f"L{L}.attn.qk.g{i}", "matmul",
            [q_slices[i]] + [k_slices[j] for j in deps],
            f"L{L}.attn.scores{i}", h * M * ctx * b, "score",
            macs=h * M * hd * ctx, mnk=(M, hd, ctx), layer=L, tag="attn.qk")
        sm = lb.vector(f"attn.softmax.g{i}", [sc], h * M * ctx, 5,
                       op_type="softmax", out_kind="score",
                       tag="attn.softmax")
        _, av = g.add_op(
            f"L{L}.attn.av.g{i}", "matmul",
            [sm] + [v_slices[j] for j in deps],
            f"L{L}.attn.ctx{i}", h * M * hd * b, "activation",
            macs=h * M * ctx * hd, mnk=(M, ctx, hd), layer=L, tag="attn.av")
        # output projection slice: rows of Wo for this head group -> partial sum
        wo = lb.weight(f"Wo.s{i}", h * hd * D)
        _, po = g.add_op(
            f"L{L}.attn.out.s{i}", "matmul", [av, wo],
            f"L{L}.attn.out.part{i}", M * D * b, "activation",
            macs=M * h * hd * D, mnk=(M, h * hd, D), layer=L, tag="attn.out")
        out_partials.append(po)

    res = lb.vector("attn.residual", [x] + out_partials, M * cfg.d_model,
                    1 + len(out_partials), tag="residual")
    return res


def _ffn_ops(lb: _LayerBuilder, x: int, d_ff: int, ffn_kind: str,
             tokens: Optional[int] = None, tag: str = "ffn") -> int:
    """Column-sliced FFN: each sub-op computes a d_ff/n slice with its own
    weight slabs, and the down-projection accumulates partial sums — weight
    slices stream through SRAM one slice at a time."""
    g, cfg, b, L = lb.g, lb.cfg, lb.b, lb.L
    M = tokens if tokens is not None else lb.M
    D = cfg.d_model
    n = lb.subops
    chunk = _ceil_div(d_ff, n)
    partials = []
    i = 0
    off = 0
    while off < d_ff:
        f = min(chunk, d_ff - off)
        if ffn_kind in ("swiglu", "geglu"):
            wg = lb.weight(f"{tag}.Wg.s{i}", D * f)
            wu = lb.weight(f"{tag}.Wu.s{i}", D * f)
            wd = lb.weight(f"{tag}.Wd.s{i}", f * D)
            _, gate = g.add_op(
                f"L{L}.{tag}.gate.s{i}", "matmul", [x, wg],
                f"L{L}.{tag}.gate.out{i}", M * f * b, "activation",
                macs=M * D * f, mnk=(M, D, f), layer=L, tag=tag)
            _, up = g.add_op(
                f"L{L}.{tag}.up.s{i}", "matmul", [x, wu],
                f"L{L}.{tag}.up.out{i}", M * f * b, "activation",
                macs=M * D * f, mnk=(M, D, f), layer=L, tag=tag)
            glu = lb.vector(f"{tag}.glu.s{i}", [gate, up], M * f, 2, tag=tag)
            _, down = g.add_op(
                f"L{L}.{tag}.down.s{i}", "matmul", [glu, wd],
                f"L{L}.{tag}.down.part{i}", M * D * b, "activation",
                macs=M * f * D, mnk=(M, f, D), layer=L, tag=tag)
        else:
            wu = lb.weight(f"{tag}.Wu.s{i}", D * f)
            wd = lb.weight(f"{tag}.Wd.s{i}", f * D)
            _, up = g.add_op(
                f"L{L}.{tag}.up.s{i}", "matmul", [x, wu],
                f"L{L}.{tag}.up.out{i}", M * f * b, "activation",
                macs=M * D * f, mnk=(M, D, f), layer=L, tag=tag)
            act = lb.vector(f"{tag}.act.s{i}", [up], M * f, 2, tag=tag)
            _, down = g.add_op(
                f"L{L}.{tag}.down.s{i}", "matmul", [act, wd],
                f"L{L}.{tag}.down.part{i}", M * D * b, "activation",
                macs=M * f * D, mnk=(M, f, D), layer=L, tag=tag)
        partials.append(down)
        off += f
        i += 1
    res = lb.vector(f"{tag}.residual", [x] + partials, M * D,
                    1 + len(partials), tag="residual")
    return res


def _moe_ops(lb: _LayerBuilder, x: int) -> int:
    """Token-choice MoE: router + top_k active expert FFNs on M*k/E tokens."""
    g, cfg, M, b, L = lb.g, lb.cfg, lb.M, lb.b, lb.L
    m = cfg.moe
    D = cfg.d_model
    wr = lb.weight("moe.Wr", D * m.num_experts)
    _, probs = g.add_op(
        f"L{L}.moe.router", "matmul", [x, wr],
        f"L{L}.moe.probs", M * m.num_experts * b, "activation",
        macs=M * D * m.num_experts, mnk=(M, D, m.num_experts), layer=L,
        tag="moe.router")
    sel = lb.vector("moe.topk", [probs], M * m.top_k, 8, tag="moe.router")

    # Average load: per expert, tokens_e = M*top_k/E; we emit one FFN per
    # *active-expert slice* aggregated into `subops` groups to bound op count.
    tokens_active = M * m.top_k
    groups = min(m.num_experts, lb.subops * 2)
    tok_per_group = _ceil_div(tokens_active, groups)
    outs = []
    for e in range(groups):
        t = min(tok_per_group, tokens_active - e * tok_per_group)
        if t <= 0:
            break
        sub = _LayerBuilder(g, cfg, t, 1, b, L)
        sub_x = lb.vector(f"moe.dispatch.e{e}", [x, sel], t * D, 1,
                          tag="moe.dispatch")
        out = _ffn_ops(sub, sub_x, m.d_ff_expert, cfg.ffn_kind, tokens=t,
                       tag=f"moe.exp{e}")
        outs.append(out)
    comb = lb.vector("moe.combine", outs, M * D, 2, tag="moe.combine")
    if m.shared_expert:
        sh = _ffn_ops(lb, x, m.d_ff_expert, cfg.ffn_kind, tag="moe.shared")
        comb = lb.vector("moe.shared_add", [comb, sh], M * D, 1,
                         tag="moe.combine")
    return comb


def _ssm_ops(lb: _LayerBuilder, x: int) -> int:
    """Mamba-2 SSD block: projections + conv + chunked scan ops."""
    g, cfg, M, b, L = lb.g, lb.cfg, lb.M, lb.b, lb.L
    s = cfg.ssm
    D = cfg.d_model
    di = s.d_inner(D)
    N = s.state_dim
    H = s.num_heads(D)
    Q = s.chunk_size

    wz = lb.weight("ssm.Wz", D * di)
    wx = lb.weight("ssm.Wx", D * di)
    wB = lb.weight("ssm.WB", D * N)
    wC = lb.weight("ssm.WC", D * N)
    z = lb.matmul_rowsplit("ssm.z", x, wz, M, D, di, tag="ssm.proj")
    xs = lb.matmul_rowsplit("ssm.x", x, wx, M, D, di, tag="ssm.proj")
    Bs = lb.matmul_rowsplit("ssm.B", x, wB, M, D, N, tag="ssm.proj")
    Cs = lb.matmul_rowsplit("ssm.C", x, wC, M, D, N, tag="ssm.proj")
    conv = lb.vector("ssm.conv", xs + Bs + Cs, M * (di + 2 * N),
                     2 * s.conv_width, tag="ssm.conv")

    nc = _ceil_div(M, Q)
    # intra-chunk quadratic term: per chunk (Q,N)x(N,Q) + (Q,Q)x(Q,P*H)
    _, intra = g.add_op(
        f"L{L}.ssm.intra", "matmul", [conv],
        f"L{L}.ssm.intra.out", M * di * b, "activation",
        macs=nc * (Q * N * Q + Q * Q * di), mnk=(M, Q, di), layer=L,
        tag="ssm.scan")
    # inter-chunk state passing: nc x (H,P,N) updates + C-contraction
    _, inter = g.add_op(
        f"L{L}.ssm.inter", "matmul", [conv, intra],
        f"L{L}.ssm.inter.out", M * di * b, "activation",
        macs=nc * (di * N) + M * di * N, mnk=(M, N, di), layer=L,
        tag="ssm.scan")
    gate = lb.vector("ssm.gate", [inter] + z, M * di, 4, tag="ssm.gate")
    wo = lb.weight("ssm.Wo", di * D)
    out = lb.matmul_rowsplit("ssm.out", gate, wo, M, di, D, tag="ssm.out")
    res = lb.vector("ssm.residual", [x] + out, M * D, 1, tag="residual")
    return res


def _rglru_ops(lb: _LayerBuilder, x: int) -> int:
    g, cfg, M, b, L = lb.g, lb.cfg, lb.M, lb.b, lb.L
    w = cfg.rglru.lru_width(cfg.d_model)
    D = cfg.d_model
    wb = lb.weight("rglru.Wb", D * w)
    wr = lb.weight("rglru.Wr", D * w)
    wa = lb.weight("rglru.Wa", w * w)
    wi = lb.weight("rglru.Wi", w * w)
    wo = lb.weight("rglru.Wo", w * D)
    br = lb.matmul_rowsplit("rglru.branch", x, wb, M, D, w, tag="rglru.proj")
    u = lb.matmul_rowsplit("rglru.rec", x, wr, M, D, w, tag="rglru.proj")
    conv = lb.vector("rglru.conv", u, M * w, 2 * cfg.rglru.conv_width,
                     tag="rglru.conv")
    ga = lb.matmul_rowsplit("rglru.gate_a", conv, wa, M, w, w, tag="rglru.gates")
    gi = lb.matmul_rowsplit("rglru.gate_i", conv, wi, M, w, w, tag="rglru.gates")
    scan = lb.vector("rglru.scan", ga + gi + [conv], M * w, 6, tag="rglru.scan")
    gated = lb.vector("rglru.mul", [scan] + br, M * w, 1, tag="rglru.gate")
    out = lb.matmul_rowsplit("rglru.out", gated, wo, M, w, D, tag="rglru.out")
    return lb.vector("rglru.residual", [x] + out, M * D, 1, tag="residual")


# ---------------------------------------------------------------------------
# Full-model graphs
# ---------------------------------------------------------------------------

def build_graph(cfg: ArchConfig, M: int = 2048, subops: int = 4,
                byte: int = 1, include_head: bool = False) -> WorkloadGraph:
    """Workload graph for one forward pass at sequence length M.

    Matches the paper's setup: int8 operands (byte=1), positional ops omitted,
    LM head omitted by default (the paper's MAC totals exclude it).
    """
    g = WorkloadGraph(name=f"{cfg.name}@M{M}")
    D = cfg.d_model
    b = byte

    # token embeddings arrive from DRAM (gather, negligible MACs)
    x = g.add_tensor("embed.out", M * D * b, "activation")

    n_pfx = cfg.frontend.num_prefix_tokens if cfg.frontend is not None else 0
    if n_pfx:
        # projector matmul for the stub modality prefix
        lb0 = _LayerBuilder(g, cfg, n_pfx, subops, b, -1)
        wp = lb0.weight("projector.W", D * D)
        pfx = g.add_tensor("prefix.embeds", n_pfx * D * b, "activation")
        _, proj = g.add_op("projector", "matmul", [pfx, wp], "projector.out",
                           n_pfx * D * b, "activation", macs=n_pfx * D * D,
                           mnk=(n_pfx, D, D), layer=-1, tag="frontend")
        _, x = g.add_op("prefix.concat", "elementwise", [x, proj],
                        "embed.full", M * D * b, "activation",
                        vector_ops=M * D, layer=-1, tag="frontend")

    def decoder_layer(x: int, kind: str, L: int) -> int:
        lb = _LayerBuilder(g, cfg, M, subops, b, L)
        x = lb.vector("norm1", [x], M * D, 4, op_type="norm", tag="norm")
        if kind in ("full", "local", "chunked"):
            x = _attention_ops(lb, x, kind)
            x2 = lb.vector("norm2", [x], M * D, 4, op_type="norm", tag="norm")
            if cfg.moe is not None:
                return _moe_ops(_LayerBuilder(g, cfg, M, subops, b, L), x2)
            return _ffn_ops(lb, x2, cfg.d_ff, cfg.ffn_kind)
        if kind == "ssm":
            return _ssm_ops(lb, x)
        if kind == "rglru":
            x = _rglru_ops(lb, x)
            lb2 = _LayerBuilder(g, cfg, M, subops, b, L)
            x2 = lb2.vector("norm2", [x], M * D, 4, op_type="norm", tag="norm")
            return _ffn_ops(lb2, x2, cfg.d_ff, cfg.ffn_kind)
        raise ValueError(kind)

    if cfg.is_encdec:
        # encoder stack (non-causal full attention) then decoder with cross
        for L, kind in enumerate(["full"] * cfg.encoder_layers):
            x = decoder_layer(x, kind, L)
        mem = x
        y = g.add_tensor("dec.embed.out", M * D * b, "activation")
        for L in range(cfg.num_layers):
            LL = cfg.encoder_layers + L
            lb = _LayerBuilder(g, cfg, M, subops, b, LL)
            y = lb.vector("norm1", [y], M * D, 4, op_type="norm", tag="norm")
            y = _attention_ops(lb, y, "full")
            # cross attention reads the encoder memory
            lbc = _LayerBuilder(g, cfg, M, subops, b, LL)
            yc = lbc.vector("norm_c", [y, mem], M * D, 4, op_type="norm",
                            tag="norm")
            y = _attention_ops(lbc, yc, "full")
            lb2 = _LayerBuilder(g, cfg, M, subops, b, LL)
            y2 = lb2.vector("norm2", [y], M * D, 4, op_type="norm", tag="norm")
            y = _ffn_ops(lb2, y2, cfg.d_ff, cfg.ffn_kind)
        x = y
    else:
        for L, kind in enumerate(cfg.layer_kinds()):
            x = decoder_layer(x, kind, L)

    lbf = _LayerBuilder(g, cfg, M, subops, b, cfg.num_layers)
    x = lbf.vector("final_norm", [x], M * D, 4, op_type="norm", tag="norm")
    if include_head:
        wh = g.add_tensor("head.W", D * cfg.vocab_size * b, "weight")
        g.add_op("lm_head", "matmul", [x, wh], "logits",
                 M * cfg.vocab_size * b, "activation",
                 macs=M * D * cfg.vocab_size, mnk=(M, D, cfg.vocab_size),
                 layer=cfg.num_layers, tag="head")
    return g


def decode_probe_contexts(start_ctx: int, steps: int,
                          n_probes: int = 3) -> List[int]:
    """Probe context lengths for the PSS decode fast path.

    Returns the endpoints of the decode horizon [start_ctx,
    start_ctx + steps - 1] plus evenly-spaced interior probes — the context
    lengths at which the exact DES is run so the per-step delta-event
    pattern can be affinely tiled (and its affinity *validated* at the
    interior probes) across the whole horizon. With `steps <= n_probes`
    every step is a probe and PSS degenerates to the exact path."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if n_probes < 2:
        raise ValueError(f"n_probes must be >= 2, got {n_probes}")
    last = start_ctx + steps - 1
    if steps <= n_probes:
        return list(range(start_ctx, last + 1))
    return sorted({start_ctx + (i * (steps - 1)) // (n_probes - 1)
                   for i in range(n_probes)})


def build_decode_graph(cfg: ArchConfig, context_len: int = 2048,
                       batch: int = 64, subops: int = 4,
                       byte: int = 1) -> WorkloadGraph:
    """One batched decode step: projections/FFN over `batch` token rows plus
    attention over a `context_len` KV cache per layer. This is the regime of
    the paper's Fig. 1 — KV-cache traffic (proportional to kv heads) dominates,
    which is where MHA vs GQA separates.
    """
    g = WorkloadGraph(name=f"{cfg.name}@decode{context_len}x{batch}")
    D = cfg.d_model
    b = byte
    Bt = batch                       # token rows this step
    x = g.add_tensor("decode.in", Bt * D * b, "activation")

    for L, kind in enumerate(cfg.layer_kinds()):
        lb = _LayerBuilder(g, cfg, Bt, min(subops, 2), b, L)
        x = lb.vector("norm1", [x], Bt * D, 4, op_type="norm", tag="norm")
        if kind in ("full", "local", "chunked"):
            H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            ctx = context_len
            if kind in ("local", "chunked") and cfg.local_window:
                ctx = min(cfg.local_window, context_len)
            wq = lb.weight("Wq", D * H * hd)
            wk = lb.weight("Wk", D * K * hd)
            wv = lb.weight("Wv", D * K * hd)
            wo = lb.weight("Wo", H * hd * D)
            _, q = g.add_op(f"L{L}.dec.q", "matmul", [x, wq], f"L{L}.dec.q.o",
                            Bt * H * hd * b, "activation",
                            macs=Bt * D * H * hd, mnk=(Bt, D, H * hd),
                            layer=L, tag="attn.proj")
            _, kk = g.add_op(f"L{L}.dec.k", "matmul", [x, wk], f"L{L}.dec.k.o",
                             Bt * K * hd * b, "kv", macs=Bt * D * K * hd,
                             mnk=(Bt, D, K * hd), layer=L, tag="attn.proj")
            _, vv = g.add_op(f"L{L}.dec.v", "matmul", [x, wv], f"L{L}.dec.v.o",
                             Bt * K * hd * b, "kv", macs=Bt * D * K * hd,
                             mnk=(Bt, D, K * hd), layer=L, tag="attn.proj")
            # the KV cache for this layer: batch x ctx x kv-dim, streamed in
            kcache = g.add_tensor(f"L{L}.kcache", Bt * ctx * K * hd * b, "kv")
            vcache = g.add_tensor(f"L{L}.vcache", Bt * ctx * K * hd * b, "kv")
            _, sc = g.add_op(
                f"L{L}.dec.qk", "matmul", [q, kk, kcache],
                f"L{L}.dec.scores", Bt * H * ctx * b, "score",
                macs=Bt * H * hd * ctx, mnk=(Bt * H, hd, ctx), layer=L,
                tag="attn.qk")
            sm = lb.vector("dec.softmax", [sc], Bt * H * ctx, 5,
                           op_type="softmax", out_kind="score",
                           tag="attn.softmax")
            _, av = g.add_op(
                f"L{L}.dec.av", "matmul", [sm, vv, vcache],
                f"L{L}.dec.ctx", Bt * H * hd * b, "activation",
                macs=Bt * H * ctx * hd, mnk=(Bt * H, ctx, hd), layer=L,
                tag="attn.av")
            _, o = g.add_op(
                f"L{L}.dec.out", "matmul", [av, wo], f"L{L}.dec.out.o",
                Bt * D * b, "activation", macs=Bt * H * hd * D,
                mnk=(Bt, H * hd, D), layer=L, tag="attn.out")
            x = lb.vector("dec.res1", [x, o], Bt * D, 2, tag="residual")
            x2 = lb.vector("norm2", [x], Bt * D, 4, op_type="norm", tag="norm")
            if cfg.moe is not None:
                x = _moe_ops(_LayerBuilder(g, cfg, Bt, 1, b, L), x2)
            else:
                x = _ffn_ops(lb, x2, cfg.d_ff, cfg.ffn_kind)
        elif kind == "ssm":
            x = _ssm_ops(lb, x)
        elif kind == "rglru":
            x = _rglru_ops(lb, x)
            lb2 = _LayerBuilder(g, cfg, Bt, 1, b, L)
            x2 = lb2.vector("norm2", [x], Bt * D, 4, op_type="norm",
                            tag="norm")
            x = _ffn_ops(lb2, x2, cfg.d_ff, cfg.ffn_kind)
    lbf = _LayerBuilder(g, cfg, Bt, 1, b, cfg.num_layers)
    g_out = lbf.vector("final_norm", [x], Bt * D, 4, op_type="norm",
                       tag="norm")
    return g
