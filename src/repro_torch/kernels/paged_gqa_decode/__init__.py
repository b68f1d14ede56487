from repro_torch.kernels.paged_gqa_decode.ops import (  # noqa: F401
    paged_gqa_decode, paged_gqa_decode_quant)
from repro_torch.kernels.paged_gqa_decode.ref import (  # noqa: F401
    gather_page_scales, gather_pages, paged_gqa_decode_quant_mirror_ref,
    paged_gqa_decode_quant_ref, paged_gqa_decode_quant_split_ref,
    paged_gqa_decode_ref, paged_gqa_decode_split_ref)
