"""SeamlessM4T-large-v2 — encoder-decoder multimodal backbone; the audio
frontend is a STUB (input_specs() yields precomputed frame embeddings).
[arXiv:2308.11596; hf]

The assignment specifies the transformer backbone only: 24L, d=1024, 16H,
d_ff=8192, vocab=256206. We realize it as 24 encoder + 24 decoder layers with
cross-attention, matching the seamless text-to-text path.
"""
from repro_torch.configs.base import ArchConfig, FrontendConfig, register

SEAMLESS_M4T_LARGE_V2 = register(ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,            # decoder depth
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    ffn_kind="gelu_mlp",
    norm="layernorm",
    pos_emb="learned",
    frontend=FrontendConfig(kind="audio", num_prefix_tokens=1024),
    source="arXiv:2308.11596; hf",
))
