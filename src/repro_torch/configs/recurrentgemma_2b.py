"""RecurrentGemma-2B — Griffin: RG-LRU recurrent blocks + local attention in a
2:1 pattern (two recurrent blocks per local-attention block), MQA kv=1.
[arXiv:2402.19427; hf]
"""
from repro_torch.configs.base import ArchConfig, RGLRUConfig, register

RECURRENTGEMMA_2B = register(ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"),
    local_window=2048,
    ffn_kind="geglu",
    norm="rmsnorm",
    pos_emb="rope",
    tie_embeddings=True,
    rglru=RGLRUConfig(conv_width=4),
    source="arXiv:2402.19427; hf",
))
