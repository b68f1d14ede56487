"""DeepSeek-Coder-33B — deep llama-arch dense GQA. [arXiv:2401.14196; hf]"""
from repro_torch.configs.base import ArchConfig, register

DEEPSEEK_CODER_33B = register(ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    ffn_kind="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    rope_theta=100_000.0,
    source="arXiv:2401.14196; hf",
))
