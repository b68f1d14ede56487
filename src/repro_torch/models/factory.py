"""Model factory and input specs; port of the reference's
`repro/models/factory.py`: a `DecoderLM` for every decoder-only config, an
`EncDecModel` for an encoder-decoder one (seamless-m4t), concrete batches
for smoke runs, and the dry run's abstract inputs (`batch_struct`,
`cache_struct`): tensors on the `meta` device, which have a shape and a
dtype and no storage, where the reference has `jax.ShapeDtypeStruct`s."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models.encdec import EncDecModel
from repro_torch.models.transformer import DecoderLM, init_cache


def build_model(cfg, *, compute_dtype=torch.bfloat16, remat: str = "full",
                device="cuda"):
    """The model class of `cfg` on `device` (the card unless the caller asks
    for the CPU): `EncDecModel` for an encoder-decoder config, else
    `DecoderLM`; `remat` is the loss's activation checkpointing."""
    cls = EncDecModel if cfg.is_encdec else DecoderLM
    return cls(cfg, compute_dtype=compute_dtype, device=device, remat=remat)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg, shape) -> Dict[str, Any]:
    """Abstract inputs of a cell's step function (`ShapeConfig` `shape`):
    train -> the batch of `loss`, prefill -> the batch of `prefill`,
    decode -> the tokens of `decode_step` (the cache is `cache_struct`).
    An encoder-decoder config adds bf16 frames (B, S, d_model) to train and
    prefill; a config with a frontend adds bf16 prefix embeddings (B,
    n_pfx, d_model) and shortens the tokens to S - n_pfx; train adds
    labels."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "decode":
        return {"tokens": _meta((B, 1), i32)}
    d: Dict[str, Any] = {}
    s_tok = S
    if cfg.is_encdec:
        d["frames"] = _meta((B, S, cfg.d_model), bf16)
    elif cfg.frontend is not None:
        s_tok = S - cfg.frontend.num_prefix_tokens
        d["prefix_embeds"] = _meta((B, cfg.frontend.num_prefix_tokens,
                                    cfg.d_model), bf16)
    d["tokens"] = _meta((B, s_tok), i32)
    if shape.kind == "train":
        d["labels"] = _meta((B, s_tok), i32)
    return d


def cache_struct(cfg, shape, dtype=torch.bfloat16) -> Dict[str, Any]:
    """Abstract dense decode cache of a decode cell (cache length =
    shape.seq_len), on the `meta` device: `init_cache`'s tree, or the
    encoder-decoder's with a memory of 4096 rows; "pos" is an int32
    scalar, as in the reference."""
    if shape.kind != "decode":
        raise ValueError(f"cache_struct is for decode cells, not "
                         f"{shape.kind}")
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        cache = EncDecModel(cfg, compute_dtype=dtype,
                            device="meta").init_cache(B, S, 4096)
    else:
        cache = init_cache(cfg, B, S, dtype, device="meta")
    cache["pos"] = _meta((), torch.int32)
    return cache


def concrete_batch(cfg, shape_kind: str, batch: int, seq: int,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
    """A small concrete batch for smoke runs, on the CPU: random tokens
    (B, seq) from `generator` (a CPU one), labels equal to the tokens for
    "train"; an encoder-decoder config also gets random bf16 frames
    (B, seq, d_model), a config with a frontend `num_prefix_tokens` random
    bf16 prefix embeddings and seq - n_pfx tokens (at least 1). The numbers
    differ from the reference's, which draws them from a JAX key."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    d: Dict[str, Any] = {}
    s_tok = seq
    if cfg.is_encdec:
        d["frames"] = torch.randn((batch, seq, cfg.d_model),
                                  generator=gen).to(torch.bfloat16)
    elif cfg.frontend is not None:
        n_pfx = cfg.frontend.num_prefix_tokens
        d["prefix_embeds"] = torch.randn(
            (batch, n_pfx, cfg.d_model), generator=gen).to(torch.bfloat16)
        s_tok = max(1, seq - n_pfx)
    d["tokens"] = torch.randint(0, cfg.vocab_size, (batch, s_tok),
                                generator=gen, dtype=torch.int32)
    if shape_kind == "train":
        d["labels"] = d["tokens"]
    return d
