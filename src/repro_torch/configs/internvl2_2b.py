"""InternVL2-2B — InternViT frontend (STUB: precomputed patch embeddings) +
InternLM2-1.8B language backbone (llama-style GQA kv=8). [arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ArchConfig, FrontendConfig, register

INTERNVL2_2B = register(ArchConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    ffn_kind="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    frontend=FrontendConfig(kind="vision", num_prefix_tokens=256),
    source="arXiv:2404.16821; hf",
))
