"""Granite-34B-Code — llama-arch with MQA (kv=1). [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ArchConfig, register

GRANITE_34B = register(ArchConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    ffn_kind="gelu_mlp",
    norm="layernorm",
    pos_emb="learned",
    tie_embeddings=True,
    source="arXiv:2405.04324; hf",
))
