"""Config system of the PyTorch port: one ArchConfig per supported
architecture + the shape registry, copied from the reference package's
`repro/configs/base.py` so that the port imports nothing of it.

The Stage-I workload graphs (`core.workload`) lower every registered config;
the port's models serve every decoder-only one (`models.DecoderLM`).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Optional


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # llama4-style shared expert that always runs alongside routed experts.
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block parameters."""
    state_dim: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU block parameters."""
    conv_width: int = 4
    # Griffin uses a small expansion on the recurrent branch.
    lru_width_multiplier: float = 1.0

    def lru_width(self, d_model: int) -> int:
        return int(d_model * self.lru_width_multiplier)


@dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend ([audio]/[vlm]): input_specs() yields precomputed
    frame/patch embeddings of shape (batch, num_prefix_tokens, d_model)."""
    kind: str  # "audio" | "vision"
    num_prefix_tokens: int = 1024


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | audio | ssm | hybrid | vlm
    num_layers: int
    d_model: int
    num_heads: int               # query heads (0 for attention-free)
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention options -------------------------------------------------
    attn_bias: bool = False                      # qwen2 uses QKV bias
    # Per-layer block pattern, cycled over the depth. Entries:
    #   "full"    — global causal self-attention
    #   "local"   — sliding-window attention (window = local_window)
    #   "chunked" — llama4-style chunked local attention (chunk = local_window)
    #   "rglru"   — RG-LRU recurrent block (no attention)
    #   "ssm"     — Mamba-2 SSD block
    block_pattern: tuple = ("full",)
    local_window: int = 0

    # --- ffn ----------------------------------------------------------------
    ffn_kind: str = "swiglu"     # swiglu | gelu_mlp | geglu
    # --- norms / embeddings ---------------------------------------------------
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    pos_emb: str = "rope"        # rope | learned | none
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    max_seq_len: int = 524_288   # cap for learned position tables / rope cache

    # --- family extensions ----------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder_layers: int = 0      # > 0 => encoder-decoder
    frontend: Optional[FrontendConfig] = None

    # --- bookkeeping ----------------------------------------------------------
    source: str = ""             # citation tag from the assignment
    # vocab padded to this multiple before sharding (standard production trick
    # so the embedding table shards evenly over the model axis).
    pad_vocab_multiple: int = 128

    # ------------------------------------------------------------------ helpers
    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return all(b in ("rglru", "ssm") for b in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True when no block does global attention over the full sequence
        (SSM / RG-LRU / local / chunked only) — or when global-attention blocks
        are a bounded minority with O(N) decode cost (llama4 chunked+full mix is
        handled by the shape-skip table, not here)."""
        return all(b in ("rglru", "ssm", "local", "chunked") for b in self.block_pattern)

    def layer_kinds(self, n: Optional[int] = None):
        """The cycled per-layer block pattern over the decoder depth."""
        n = self.num_layers if n is None else n
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(n))

    # --- analytic parameter count (used for MODEL_FLOPS + sanity tests) -------
    def param_count(self) -> int:
        D, Dff, V = self.d_model, self.d_ff, self.padded_vocab
        total = V * D                      # token embedding
        if not self.tie_embeddings:
            total += V * D                 # lm head
        if self.pos_emb == "learned":
            total += min(self.max_seq_len, 32768) * D

        def attn_params() -> int:
            p = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
            if self.attn_bias:
                p += self.q_dim + 2 * self.kv_dim
            return p

        def ffn_params(dff: int) -> int:
            mult = 3 if self.ffn_kind in ("swiglu", "geglu") else 2
            return mult * D * dff

        def moe_params() -> int:
            assert self.moe is not None
            p = self.moe.num_experts * ffn_params(self.moe.d_ff_expert)
            p += D * self.moe.num_experts          # router
            if self.moe.shared_expert:
                p += ffn_params(self.moe.d_ff_expert)
            return p

        def ssm_params() -> int:
            assert self.ssm is not None
            di = self.ssm.d_inner(D)
            nh = self.ssm.num_heads(D)
            ns = self.ssm.state_dim
            # in_proj produces [z, x, B, C, dt]; out_proj back to D.
            p = D * (2 * di + 2 * ns + nh) + di * D
            p += self.ssm.conv_width * (di + 2 * ns)   # causal conv
            p += nh * 2                                 # A_log, D per head
            return p

        def rglru_params() -> int:
            assert self.rglru is not None
            w = self.rglru.lru_width(D)
            # gated branches in/out + conv + input/forget gates (diagonal-ish)
            return 2 * D * w + w * D + self.rglru.conv_width * w + 2 * w * w // max(1, w // 256)

        for kind in self.layer_kinds():
            if kind in ("full", "local", "chunked"):
                total += attn_params()
            elif kind == "ssm":
                total += ssm_params()
            elif kind == "rglru":
                total += rglru_params()
            # FFN for every block except pure-SSM archs (mamba blocks have no MLP)
            if kind != "ssm":
                total += moe_params() if self.moe is not None else ffn_params(Dff)
            total += 2 * D                      # norms

        if self.is_encdec:
            # encoder self-attn + ffn, decoder additionally cross-attn
            enc = self.encoder_layers * (attn_params() + ffn_params(Dff) + 2 * D)
            cross = self.num_layers * (attn_params() + D)
            total += enc + cross
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        m = self.moe

        def ffn_p(dff):
            mult = 3 if self.ffn_kind in ("swiglu", "geglu") else 2
            return mult * self.d_model * dff

        moe_layers = sum(1 for k in self.layer_kinds() if k != "ssm")
        inactive = moe_layers * (m.num_experts - m.top_k) * ffn_p(m.d_ff_expert)
        return full - inactive


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}

# Archs allowed to run long_500k (sub-quadratic or bounded-KV attention).
LONG_CONTEXT_OK = frozenset({
    "mamba2-130m", "recurrentgemma-2b", "llama4-scout-17b-a16e",
})


def shape_supported(arch: "ArchConfig", shape: ShapeConfig) -> tuple:
    """(supported, reason) — encodes the assignment's skip rules."""
    if shape.name == "long_500k" and arch.name not in LONG_CONTEXT_OK:
        return False, "pure full-attention arch: 500k-token KV skip per assignment"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    assert cfg.name not in _REGISTRY, f"duplicate arch {cfg.name}"
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    # import side-effect registration
    from repro_torch import configs as _c  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def resolve_arch(name: str) -> ArchConfig:
    """`get_arch` that also accepts module-style spellings: separators and
    case are ignored, so "dsr1d_qwen_1_5b" == "dsr1d-qwen-1.5b"."""
    from repro_torch import configs as _c  # noqa: F401
    if name in _REGISTRY:
        return _REGISTRY[name]

    def canon(s: str) -> str:
        return "".join(ch for ch in s.lower() if ch.isalnum())

    matches = [k for k in _REGISTRY if canon(k) == canon(name)]
    if len(matches) != 1:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[matches[0]]


def list_archs() -> list:
    from repro_torch import configs as _c  # noqa: F401
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------

def reduced(cfg: ArchConfig, *, layers: Optional[int] = None) -> ArchConfig:
    """A tiny config of the same family: same block pattern/features, small dims.

    Used by smoke tests and CPU examples; the FULL configs are only ever
    lowered via ShapeDtypeStructs in the dry-run.
    """
    pat = len(cfg.block_pattern)
    n_layers = layers if layers is not None else max(2, 2 * pat)
    # keep the pattern intact across the reduced depth
    n_layers = max(n_layers, pat)
    head_dim = 16
    n_heads = max(2, min(4, cfg.num_heads or 2))
    n_kv = max(1, min(cfg.num_kv_heads, n_heads)) if cfg.num_heads else 0
    # preserve MQA/GQA/MHA character
    if cfg.num_heads and cfg.num_kv_heads == cfg.num_heads:
        n_kv = n_heads
    elif cfg.num_heads and cfg.num_kv_heads == 1:
        n_kv = 1
    elif cfg.num_heads:
        n_kv = max(1, n_heads // 2)
    d_model = 64
    kw = dict(
        name=cfg.name + "-reduced",
        num_layers=n_layers,
        d_model=d_model,
        num_heads=n_heads if cfg.num_heads else 0,
        num_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=128,
        vocab_size=256,
        max_seq_len=512,
        local_window=min(cfg.local_window, 64) if cfg.local_window else 0,
        pad_vocab_multiple=32,
    )
    if cfg.moe is not None:
        kw["moe"] = replace(cfg.moe, num_experts=4,
                            top_k=min(cfg.moe.top_k, 2), d_ff_expert=64)
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, state_dim=16, head_dim=16, chunk_size=32)
    if cfg.rglru is not None:
        kw["rglru"] = cfg.rglru
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
    if cfg.frontend is not None:
        kw["frontend"] = replace(cfg.frontend, num_prefix_tokens=8)
    out = replace(cfg, **kw)
    # registry guard: reduced configs are never registered
    return out
