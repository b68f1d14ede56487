"""GPT-2 XL — the paper's MHA workload (TRAPTI Table I): 48L, d=1600, 25H MHA,
d_ff=6400, vocab 50257, learned positions, GELU MLP. [Radford et al. 2019]
"""
from repro_torch.configs.base import ArchConfig, register

GPT2_XL = register(ArchConfig(
    name="gpt2-xl",
    family="dense",
    num_layers=48,
    d_model=1600,
    num_heads=25,
    num_kv_heads=25,       # MHA
    head_dim=64,
    d_ff=6400,
    vocab_size=50257,
    ffn_kind="gelu_mlp",
    norm="layernorm",
    pos_emb="learned",
    tie_embeddings=True,
    max_seq_len=2048,
    source="paper Table I (TRAPTI); Radford et al. 2019",
))
