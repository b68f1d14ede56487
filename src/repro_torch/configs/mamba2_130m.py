"""Mamba2-130m — attention-free SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

MAMBA2_130M = register(ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,           # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                # mamba blocks carry no MLP
    vocab_size=50280,
    block_pattern=("ssm",),
    norm="rmsnorm",
    pos_emb="none",
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, expand=2, head_dim=64, conv_width=4,
                  chunk_size=256),
    source="arXiv:2405.21060; unverified",
))
