"""Parameters of the port's models: the reference's trees, as tensors.

The tree has the reference's keys and shapes (`repro/models/transformer.py`
`lm_template`): {"embed": {"tok", ["pos"], ["head"]}, "blocks": [one
stacked block dict per pattern slot, with a leading repetition axis],
"tail": [unstacked blocks past the last whole repetition], "final_norm":
{...}, ["projector": {"w", "b"}]}, for every decoder family (attention
with a dense or MoE FFN, RG-LRU and SSD blocks, the VLM projector). An
encoder-decoder config (seamless-m4t) has the reference's `encdec_template`
tree instead (`repro/models/encdec.py`): {"embed", "enc_pos", "encoder": a
stacked block dict over the encoder layers, "enc_norm", "decoder": a
stacked dict over the decoder layers with "self_attn" and "cross_attn",
"final_norm"}.

  * `param_axes` names each leaf's logical axes (the reference's
    `PTpl.axes`), for the sharding rules of `models.sharding`.
  * `from_jax_params` carries weights across from the reference: its
    `DecoderLM.init` params, brought to numpy (`jax.device_get`), become
    tensors on a device, key for key.
  * `init_params` draws full-width random weights from a `torch.Generator`
    with no JAX present, with the reference's initialiser scales (normal
    with std = scale / sqrt(fan_in), 0.02 for embeddings, zeros / ones for
    biases and norms). The numbers differ from JAX's for the same seed.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.device import require_device

# leaf spec: (shape, init) with init in normal | embed | zeros | ones
Spec = Tuple[Tuple[int, ...], str]
# float32 bytes above which `init_params` draws a stacked leaf slice by slice
_DRAW_LIMIT = 2 << 30

# The private functions below make leaves (shape, init, axes): the
# reference's `PTpl` without its scale and dtype. `axes` names each dim's
# logical axis (`models.sharding` maps them onto a mesh). `param_specs`
# keeps (shape, init), `param_axes` the axes.


def _norm(cfg) -> Dict[str, tuple]:
    d, e = cfg.d_model, ("embed",)
    if cfg.norm == "layernorm":
        return {"scale": ((d,), "ones", e), "bias": ((d,), "zeros", e)}
    return {"scale": ((d,), "zeros", e)}    # rmsnorm stores (gain - 1)


def _attn(cfg, cross: bool = False) -> Dict[str, tuple]:
    D, Q, KV = cfg.d_model, cfg.q_dim, cfg.kv_dim
    into, out = ("embed", "qkv_out"), ("qkv_out", "embed")
    t = {"wq": ((D, Q), "normal", into), "wk": ((D, KV), "normal", into),
         "wv": ((D, KV), "normal", into), "wo": ((Q, D), "normal", out)}
    if cfg.attn_bias and not cross:
        b = ("qkv_out",)
        t.update(bq=((Q,), "zeros", b), bk=((KV,), "zeros", b),
                 bv=((KV,), "zeros", b))
    return t


def _gated(D: int, F: int) -> Dict[str, tuple]:
    return {"w_gate": ((D, F), "normal", ("embed", "mlp")),
            "w_up": ((D, F), "normal", ("embed", "mlp")),
            "w_down": ((F, D), "normal", ("mlp", "embed"))}


def _ffn(cfg) -> Dict[str, tuple]:
    D, F = cfg.d_model, cfg.d_ff
    if cfg.ffn_kind in ("swiglu", "geglu"):
        return _gated(D, F)
    return {"w_up": ((D, F), "normal", ("embed", "mlp")),
            "b_up": ((F,), "zeros", ("mlp",)),
            "w_down": ((F, D), "normal", ("mlp", "embed")),
            "b_down": ((D,), "zeros", ("embed",))}


def _moe(cfg) -> Dict[str, Any]:
    m = cfg.moe
    D, F, E = cfg.d_model, m.d_ff_expert, m.num_experts
    t = {"router": ((D, E), "normal", ("embed", "experts")),
         "w_gate": ((E, D, F), "normal", ("experts", "embed", "mlp")),
         "w_up": ((E, D, F), "normal", ("experts", "embed", "mlp")),
         "w_down": ((E, F, D), "normal", ("experts", "mlp", "embed"))}
    if m.shared_expert:
        t["shared"] = _gated(D, F)
    return t


def _rglru(cfg) -> Dict[str, tuple]:
    g = cfg.rglru
    D = cfg.d_model
    w = g.lru_width(D)
    return {"w_branch": ((D, w), "normal", ("embed", "lru")),
            "w_rec": ((D, w), "normal", ("embed", "lru")),
            "conv": ((g.conv_width, w), "normal", ("conv", "lru")),
            "w_a": ((w, w), "normal", ("lru", "lru")),
            "w_i": ((w, w), "normal", ("lru", "lru")),
            "lam": ((w,), "ones", ("lru",)),
            "wo": ((w, D), "normal", ("lru", "embed"))}


def _ssm(cfg) -> Dict[str, tuple]:
    s = cfg.ssm
    D = cfg.d_model
    di, N, H, cw = s.d_inner(D), s.state_dim, s.num_heads(D), s.conv_width
    inner, state = ("embed", "ssm_inner"), ("embed", "state")
    return {"wz": ((D, di), "normal", inner),
            "wx": ((D, di), "normal", inner),
            "wB": ((D, N), "normal", state), "wC": ((D, N), "normal", state),
            "wdt": ((D, H), "normal", ("embed", "heads")),
            "dt_bias": ((H,), "zeros", ("heads",)),
            "A_log": ((H,), "ones", ("heads",)),
            "D": ((H,), "ones", ("heads",)),
            "conv_x": ((cw, di), "normal", ("conv", "ssm_inner")),
            "conv_B": ((cw, N), "normal", ("conv", "state")),
            "conv_C": ((cw, N), "normal", ("conv", "state")),
            "norm": ((di,), "zeros", ("ssm_inner",)),
            "wo": ((di, D), "normal", ("ssm_inner", "embed"))}


def _block(cfg, kind: str) -> Dict[str, Any]:
    """One block's leaves (the reference's `block_template`)."""
    if kind in ("full", "local", "chunked"):
        return {"norm1": _norm(cfg), "attn": _attn(cfg),
                "norm2": _norm(cfg),
                "ffn": _moe(cfg) if cfg.moe is not None else _ffn(cfg)}
    if kind == "rglru":
        return {"norm1": _norm(cfg), "rec": _rglru(cfg),
                "norm2": _norm(cfg), "ffn": _ffn(cfg)}
    if kind == "ssm":
        return {"norm1": _norm(cfg), "ssm": _ssm(cfg)}
    raise ValueError(kind)


def _stacked(tree, n: int):
    """A leading stacking dim of size `n` on every leaf, named "layers"."""
    if isinstance(tree, dict):
        return {k: _stacked(v, n) for k, v in tree.items()}
    shape, init, axes = tree
    return ((n,) + shape, init, ("layers",) + axes)


def _select(tree, fn):
    """`fn` of every leaf of such a tree (dicts and lists kept)."""
    if isinstance(tree, dict):
        return {k: _select(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_select(v, fn) for v in tree]
    return fn(tree)


def _specs(tree):
    return _select(tree, lambda leaf: leaf[:2])


def require_decoder(cfg) -> None:
    """Refuse an encoder-decoder config where the reference has no
    encoder-decoder path: `DecoderLM` and the paged cache (seamless-m4t
    runs as `EncDecModel`, served by `BatchedServer`)."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder: it runs as EncDecModel "
            "(models/encdec.py, served by BatchedServer); the decoder-only "
            "model and the paged cache have no encoder-decoder path, as "
            "in the reference")


def _embed(cfg) -> Dict[str, tuple]:
    D, V = cfg.d_model, cfg.padded_vocab
    embed = {"tok": ((V, D), "embed", ("vocab", "embed"))}
    if cfg.pos_emb == "learned":
        embed["pos"] = ((min(cfg.max_seq_len, 32768), D), "embed",
                        ("seq_table", "embed"))
    if not cfg.tie_embeddings:
        embed["head"] = ((D, V), "normal", ("embed", "vocab"))
    return embed


def _enc_block(cfg) -> Dict[str, Any]:
    return {"norm1": _norm(cfg), "attn": _attn(cfg), "norm2": _norm(cfg),
            "ffn": _ffn(cfg)}


def _dec_block(cfg) -> Dict[str, Any]:
    return {"norm1": _norm(cfg), "self_attn": _attn(cfg),
            "norm_c": _norm(cfg), "cross_attn": _attn(cfg, cross=True),
            "norm2": _norm(cfg), "ffn": _ffn(cfg)}


def _encdec(cfg) -> Dict[str, Any]:
    return {"embed": _embed(cfg),
            "enc_pos": ((min(cfg.max_seq_len, 32768), cfg.d_model), "embed",
                        ("seq_table", "embed")),
            "encoder": _stacked(_enc_block(cfg), cfg.encoder_layers),
            "enc_norm": _norm(cfg),
            "decoder": _stacked(_dec_block(cfg), cfg.num_layers),
            "final_norm": _norm(cfg)}


def enc_block_template(cfg) -> Dict[str, Any]:
    """One encoder block (the reference's `enc_block_template`)."""
    return _specs(_enc_block(cfg))


def dec_block_template(cfg) -> Dict[str, Any]:
    """One decoder block (the reference's `dec_block_template`): self
    attention, cross attention without bias, FFN."""
    return _specs(_dec_block(cfg))


def encdec_template(cfg) -> Dict[str, Any]:
    """The reference's `encdec_template`: the learned encoder positions, the
    encoder blocks stacked over `encoder_layers`, the decoder blocks
    stacked over `num_layers`."""
    return _specs(_encdec(cfg))


def _template(cfg) -> Dict[str, Any]:
    if cfg.is_encdec:
        return _encdec(cfg)
    pat = cfg.block_pattern
    n_rep = cfg.num_layers // len(pat)
    t = {"embed": _embed(cfg),
         "blocks": [_stacked(_block(cfg, k), n_rep) for k in pat],
         "tail": [_block(cfg, k)
                  for k in cfg.layer_kinds()[n_rep * len(pat):]],
         "final_norm": _norm(cfg)}
    if cfg.frontend is not None:
        t["projector"] = {
            "w": ((cfg.d_model, cfg.d_model), "normal", ("embed", "mlp")),
            "b": ((cfg.d_model,), "zeros", ("embed",))}
    return t


def param_specs(cfg) -> Dict[str, Any]:
    """The tree of (shape, init) leaves the reference's template describes.
    Decoder-only configs (`lm_template`): one stacked dict per pattern slot
    (leading axis n_rep = num_layers // len(pattern)), the unstacked tail
    blocks, and the projector of configs with a frontend. Encoder-decoder
    configs: `encdec_template`."""
    return _specs(_template(cfg))


def param_axes(cfg) -> Dict[str, Any]:
    """The logical axis names of every leaf of `param_specs(cfg)`: the same
    tree with a tuple of names per leaf, one per dim (the reference's
    `PTpl.axes`; stacked leaves lead with "layers")."""
    return _select(_template(cfg), lambda leaf: leaf[2])


def map_tree(spec, tree, fn, path=""):
    """`fn(spec_leaf, tree_leaf, path)` over two trees of one structure
    (dicts and lists; anything else is a leaf), walked by `spec`; raises
    where `tree` has other keys or lengths."""
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec):
            raise ValueError(f"param tree mismatch at {path or '/'}: "
                             f"expected keys {sorted(spec)}")
        return {k: map_tree(spec[k], tree[k], fn, f"{path}/{k}")
                for k in spec}
    if isinstance(spec, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(spec):
            raise ValueError(f"param tree mismatch at {path}: expected a "
                             f"list of {len(spec)}")
        return [map_tree(s, t, fn, f"{path}/{i}")
                for i, (s, t) in enumerate(zip(spec, tree))]
    return fn(spec, tree, path)


def from_jax_params(tree, cfg, device="cuda",
                    dtype: torch.dtype = None) -> Dict[str, Any]:
    """Map the reference's params (a tree of numpy arrays) onto tensors on
    `device`, keeping each array's dtype unless `dtype` is given. Raises if
    a key or shape differs from `param_specs(cfg)`."""
    dev = require_device(device)

    def leaf(spec, x, path):
        arr = np.asarray(x)
        if tuple(arr.shape) != tuple(spec[0]):
            raise ValueError(f"{path}: shape {arr.shape}, expected {spec[0]}")
        t = torch.tensor(arr)
        return t.to(device=dev, dtype=dtype or t.dtype)

    return map_tree(param_specs(cfg), tree, leaf)


def init_params(cfg, generator: torch.Generator, device="cuda",
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random weights at the config's full width, drawn from `generator`
    (which must live on `device`) with the reference's initialiser
    scales."""
    dev = require_device(device)
    specs = param_specs(cfg)

    def leaf(spec, _, path):
        shape, init = spec
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=dev)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=dev)
        std = 0.02 if init == "embed" else 1.0 / math.sqrt(
            max(1, shape[-2] if len(shape) >= 2 else shape[-1]))
        if len(shape) >= 3 and 4 * math.prod(shape) > _DRAW_LIMIT:
            # a stacked leaf too large to draw in float32 at once (olmoe's
            # experts: 8.6 GB) is drawn one leading index at a time
            out = torch.empty(shape, dtype=dtype, device=dev)
            for i in range(shape[0]):
                x = torch.randn(shape[1:], generator=generator,
                                dtype=torch.float32, device=dev)
                out[i] = (x * std).to(dtype)
            return out
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (x * std).to(dtype)

    return map_tree(specs, specs, leaf)
