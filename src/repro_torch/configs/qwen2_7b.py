"""Qwen2-7B — dense GQA decoder, QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ArchConfig, register

QWEN2_7B = register(ArchConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    attn_bias=True,
    ffn_kind="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671; hf",
))
