"""Tiny cells for the CPU tests: each configuration family at the program's
`reduced(..., layers=2)` sizes, under a short backlog, through the same
harness code as the benchmark's cells (the program's plain PyTorch path)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs import get_arch
from repro_torch.configs.base import reduced

from portbench.harness.spec import Cell

ARCHS = {"qwen2": "dsr1d-qwen-1.5b", "gpt2": "gpt2-xl"}


def tiny_config(family: str) -> dict:
    """A configuration file's dict for the family's reduced config."""
    a = tiny_arch(family)
    if family == "qwen2":
        return {"arch": a.name, "model_type": "qwen2", "hidden_act": "silu",
                "hidden_size": a.d_model, "intermediate_size": a.d_ff,
                "num_attention_heads": a.num_heads,
                "num_key_value_heads": a.num_kv_heads,
                "num_hidden_layers": a.num_layers,
                "vocab_size": a.vocab_size, "rms_norm_eps": 1e-6,
                "rope_theta": a.rope_theta, "tie_word_embeddings": False,
                "kv_dtype": "bf16", "page_size": 16}
    return {"arch": a.name, "model_type": "gpt2",
            "activation_function": "gelu_new", "n_embd": a.d_model,
            "n_head": a.num_heads, "n_layer": a.num_layers,
            "n_inner": a.d_ff, "n_positions": a.max_seq_len,
            "vocab_size": a.vocab_size, "layer_norm_epsilon": 1e-5,
            "tie_word_embeddings": True, "kv_dtype": "bf16", "page_size": 16}


def tiny_arch(family: str):
    """The family's config at two layers; qwen2's LM head untied, as
    DeepSeek-R1-Distill-Qwen-1.5B publishes it and its cell runs it."""
    a = reduced(get_arch(ARCHS[family]), layers=2)
    return dataclasses.replace(a, tie_embeddings=family == "gpt2")


MIX = {"arrivals": "backlog", "block": 8, "pairing_seed": 0,
       "prompt": {"mean": 40, "sigma": 0.4, "min": 16, "max": 64},
       "output": {"mean": 10, "sigma": 0.5, "min": 6, "max": 16}}


# `gap` limits of the tiny cells, set from CPU readings (test_portbench_faults)
GAP_LIMITS = {"qwen2": 0.016, "gpt2": 0.008}


def tiny_cell(family: str, gap_limit: Optional[float] = None,
              kv_limit: float = 0.01) -> Cell:
    gap = GAP_LIMITS[family] if gap_limit is None else gap_limit
    limits = {"gap": gap, "kv_err": kv_limit, "len_mismatch": 0}
    return Cell(name=f"tiny-{family}", chips=1, config_name=family,
                config=tiny_config(family), traffic=MIX,
                workload={"slots": 4, "chunk_steps": 4, "pool_pages": 21,
                          "profile_cycles": 2,
                          "check": {"sample_tokens": 64, "max_requests": 12,
                                    "limits": limits}})
