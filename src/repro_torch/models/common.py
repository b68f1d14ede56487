"""Shared model building blocks of the port: norms, RoPE, embeddings, the
LM head and the training loss's cross entropy (port of the reference's
`repro/models/common.py`), and `checkpointed`, the reference's `remat`
policies on `torch.utils.checkpoint`.

Parameters are plain dictionaries of tensors with the reference's keys and
shapes (`repro_torch.params`). Norms and RoPE compute in float32 and return
the input dtype, as the reference does."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm; `scale` stores (gain - 1), as the reference initialises it."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def apply_norm(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                 # (d/2,)
    ang = positions[..., :, None].float() * freqs                # (..., S, d/2)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_tokens(cfg, p: dict, tokens: torch.Tensor, positions: torch.Tensor,
                 dtype) -> torch.Tensor:
    """Token embedding, plus learned positions (clipped to the table) for
    `pos_emb == "learned"` (gpt2-xl)."""
    x = p["tok"].to(dtype)[tokens]
    if cfg.pos_emb == "learned":
        table = p["pos"].shape[0]
        x = x + p["pos"].to(dtype)[positions.clamp(0, table - 1)]
    return x


def lm_logits(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied (or separate) LM head; the padded tail of the vocabulary gets
    -1e9 so it never wins an argmax."""
    if cfg.tie_embeddings:
        logits = x @ p["tok"].to(x.dtype).T
    else:
        logits = x @ p["head"].to(x.dtype)
    if cfg.padded_vocab != cfg.vocab_size:
        mask = torch.zeros(cfg.padded_vocab, dtype=logits.dtype,
                           device=logits.device)
        mask[cfg.vocab_size:] = -1e9
        logits = logits + mask
    return logits


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean cross entropy over the positions whose label is not
    `ignore_id`, in float32; logits (..., V), labels (...) integer."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      labels.long().clamp_min(0)[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return ((lse - ll) * mask).sum() / mask.sum().clamp_min(1.0)


def _save_weight_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat "dots": keep the outputs of
    matrix products without batch dimensions, recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(remat: str, fn):
    """`fn` under the reference's `remat` policy (`jax.checkpoint` in
    `repro/models/transformer.py`), on `torch.utils.checkpoint`:

      * "none": `fn` itself; autograd keeps every activation;
      * "full": `checkpoint(fn)`: only `fn`'s inputs are kept, and its
        forward runs again in the backward;
      * "dots": selective checkpointing that keeps the outputs of aten
        `mm`/`addmm` (the weight products: `x @ W` on a (B, S, D)
        activation runs as one mm) and recomputes the rest. JAX's
        `checkpoint_dots_with_no_batch_dims` keeps every dot_general
        without batch dimensions of the traced, rewritten graph; torch
        decides per operator at dispatch, so the saved set is the same
        in intent (weight products kept, attention's batched products
        recomputed) but not guaranteed equal op for op.

    Values and gradients are the same under every mode; only memory and
    time differ. Outside grad mode `fn` runs as it is."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none, full or dots, got {remat!r}")
    if remat == "none":
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        kw = {}
        if remat == "dots":
            kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
                _save_weight_products)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return run
