"""DeepSeek-R1-Distill-Qwen-1.5B — the paper's GQA workload (TRAPTI Table I):
28L, d=1536, 12 query heads / 2 KV heads (head_dim 128), d_ff=8960 SwiGLU.
[Guo et al. 2025; paper Table I]
"""
from repro_torch.configs.base import ArchConfig, register

DSR1D_QWEN_1_5B = register(ArchConfig(
    name="dsr1d-qwen-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    attn_bias=True,
    ffn_kind="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    vocab_size=151936,
    tie_embeddings=True,
    source="paper Table I (TRAPTI); DeepSeek-R1 distill",
))
