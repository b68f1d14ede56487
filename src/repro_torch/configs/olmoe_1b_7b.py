"""OLMoE-1B-7B — 64-expert top-8 MoE, full-head attention. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

OLMOE_1B_7B = register(ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,            # per-expert hidden dim
    vocab_size=50304,
    ffn_kind="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
    source="arXiv:2409.02060; hf",
))
