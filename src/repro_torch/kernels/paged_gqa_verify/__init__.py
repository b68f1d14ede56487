from repro_torch.kernels.paged_gqa_verify.ops import paged_gqa_verify  # noqa: F401
from repro_torch.kernels.paged_gqa_verify.ref import (  # noqa: F401
    paged_gqa_verify_ref, paged_gqa_verify_split_ref)
