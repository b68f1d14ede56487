from repro_torch.kernels.paged_gqa_decode.ops import paged_gqa_decode  # noqa: F401
from repro_torch.kernels.paged_gqa_decode.ref import (  # noqa: F401
    gather_pages, paged_gqa_decode_ref)
