from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention, variant)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    MIRROR_ATOL, bf16_excess, bf16_step, flash_attention_bf16_mirror_ref,
    flash_attention_ref)
