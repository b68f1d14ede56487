"""Model factory and concrete input batches; port of the reference's
`repro/models/factory.py`: a `DecoderLM` for every decoder-only config, an
`EncDecModel` for an encoder-decoder one (seamless-m4t). The abstract
dry-run inputs (`batch_struct`, `cache_struct`) come with the dry-run
CLI."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models.encdec import EncDecModel
from repro_torch.models.transformer import DecoderLM


def build_model(cfg, *, compute_dtype=torch.bfloat16, remat: str = "full",
                device="cuda"):
    """The model class of `cfg` on `device` (the card unless the caller asks
    for the CPU): `EncDecModel` for an encoder-decoder config, else
    `DecoderLM`; `remat` is the loss's activation checkpointing."""
    cls = EncDecModel if cfg.is_encdec else DecoderLM
    return cls(cfg, compute_dtype=compute_dtype, device=device, remat=remat)


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
