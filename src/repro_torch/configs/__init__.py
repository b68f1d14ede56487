"""Arch config registry of the port — importing this package registers
every config of the reference's `repro/configs`."""
from repro_torch.configs.base import (
    ArchConfig, MoEConfig, SSMConfig, RGLRUConfig, FrontendConfig,
    ShapeConfig, SHAPES, LONG_CONTEXT_OK,
    get_arch, list_archs, reduced, register, resolve_arch, shape_supported,
)

# Assigned architectures (10)
from repro_torch.configs.qwen2_7b import QWEN2_7B
from repro_torch.configs.tinyllama_1_1b import TINYLLAMA_1_1B
from repro_torch.configs.deepseek_coder_33b import DEEPSEEK_CODER_33B
from repro_torch.configs.granite_34b import GRANITE_34B
from repro_torch.configs.olmoe_1b_7b import OLMOE_1B_7B
from repro_torch.configs.llama4_scout_17b_a16e import LLAMA4_SCOUT
from repro_torch.configs.seamless_m4t_large_v2 import SEAMLESS_M4T_LARGE_V2
from repro_torch.configs.mamba2_130m import MAMBA2_130M
from repro_torch.configs.recurrentgemma_2b import RECURRENTGEMMA_2B
from repro_torch.configs.internvl2_2b import INTERNVL2_2B

# Paper workloads (TRAPTI Table I)
from repro_torch.configs.gpt2_xl import GPT2_XL
from repro_torch.configs.dsr1d_qwen_1_5b import DSR1D_QWEN_1_5B

ASSIGNED_ARCHS = (
    "qwen2-7b", "tinyllama-1.1b", "deepseek-coder-33b", "granite-34b",
    "olmoe-1b-7b", "llama4-scout-17b-a16e", "seamless-m4t-large-v2",
    "mamba2-130m", "recurrentgemma-2b", "internvl2-2b",
)
PAPER_ARCHS = ("gpt2-xl", "dsr1d-qwen-1.5b")

__all__ = [
    "ArchConfig", "MoEConfig", "SSMConfig", "RGLRUConfig", "FrontendConfig",
    "ShapeConfig", "SHAPES", "LONG_CONTEXT_OK", "get_arch", "list_archs",
    "reduced", "register", "resolve_arch", "shape_supported",
    "ASSIGNED_ARCHS", "PAPER_ARCHS",
]
