"""Parameters of the port's decoder: the reference's tree, as tensors.

The tree has the reference's keys and shapes (`repro/models/transformer.py`
`lm_template`): {"embed": {"tok", ["pos"], ["head"]}, "blocks": [stacked
block dict with a leading layer axis], "tail": [], "final_norm": {...}}.

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
from repro_torch.models.transformer import require_full_attention

# leaf spec: (shape, init) with init in normal | embed | zeros | ones
Spec = Tuple[Tuple[int, ...], str]


def _norm(cfg) -> Dict[str, Spec]:
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": ((d,), "ones"), "bias": ((d,), "zeros")}
    return {"scale": ((d,), "zeros")}       # rmsnorm stores (gain - 1)


def _block(cfg) -> Dict[str, Any]:
    D, Q, KV, F = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    attn = {"wq": ((D, Q), "normal"), "wk": ((D, KV), "normal"),
            "wv": ((D, KV), "normal"), "wo": ((Q, D), "normal")}
    if cfg.attn_bias:
        attn.update(bq=((Q,), "zeros"), bk=((KV,), "zeros"),
                    bv=((KV,), "zeros"))
    if cfg.ffn_kind == "swiglu":
        ffn = {"w_gate": ((D, F), "normal"), "w_up": ((D, F), "normal"),
               "w_down": ((F, D), "normal")}
    else:
        ffn = {"w_up": ((D, F), "normal"), "b_up": ((F,), "zeros"),
               "w_down": ((F, D), "normal"), "b_down": ((D,), "zeros")}
    return {"norm1": _norm(cfg), "attn": attn, "norm2": _norm(cfg),
            "ffn": ffn}


def _stacked(tree, n: int):
    if isinstance(tree, dict):
        return {k: _stacked(v, n) for k, v in tree.items()}
    shape, init = tree
    return ((n,) + shape, init)


def param_specs(cfg) -> Dict[str, Any]:
    """The tree of (shape, init) leaves the reference's `lm_template`
    describes, for a dense full-attention config."""
    require_full_attention(cfg)
    embed = {"tok": ((cfg.padded_vocab, cfg.d_model), "embed")}
    if cfg.pos_emb == "learned":
        embed["pos"] = ((min(cfg.max_seq_len, 32768), cfg.d_model), "embed")
    if not cfg.tie_embeddings:
        embed["head"] = ((cfg.d_model, cfg.padded_vocab), "normal")
    return {"embed": embed, "blocks": [_stacked(_block(cfg), cfg.num_layers)],
            "tail": [], "final_norm": _norm(cfg)}


def _map(spec, tree, fn, path=""):
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec):
            raise ValueError(f"param tree mismatch at {path or '/'}: "
                             f"expected keys {sorted(spec)}")
        return {k: _map(spec[k], tree[k], fn, f"{path}/{k}") for k in spec}
    if isinstance(spec, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(spec):
            raise ValueError(f"param tree mismatch at {path}: expected a "
                             f"list of {len(spec)}")
        return [_map(s, t, fn, f"{path}/{i}")
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

    return _map(param_specs(cfg), tree, leaf)


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
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (x * std).to(dtype)

    return _map(specs, specs, leaf)
