"""Arch config registry of the port: importing this package registers the
paper's two workloads (TRAPTI Table I)."""
from repro_torch.configs.base import (ArchConfig, FrontendConfig, MoEConfig,
                                      RGLRUConfig, SSMConfig, get_arch,
                                      list_archs, reduced, register)
from repro_torch.configs.dsr1d_qwen_1_5b import DSR1D_QWEN_1_5B
from repro_torch.configs.gpt2_xl import GPT2_XL

PAPER_ARCHS = ("gpt2-xl", "dsr1d-qwen-1.5b")

__all__ = [
    "ArchConfig", "MoEConfig", "SSMConfig", "RGLRUConfig", "FrontendConfig",
    "get_arch", "list_archs", "reduced", "register", "PAPER_ARCHS",
    "DSR1D_QWEN_1_5B", "GPT2_XL",
]
