"""Llama-4-Scout-17B-16E — top-1 MoE with shared expert; chunked local attention
(8192) on 3/4 layers with global (NoPE) attention every 4th layer.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

LLAMA4_SCOUT = register(ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,            # per-expert hidden dim
    vocab_size=202048,
    ffn_kind="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    rope_theta=500_000.0,
    block_pattern=("chunked", "chunked", "chunked", "full"),
    local_window=8192,
    moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192, shared_expert=True),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
))
