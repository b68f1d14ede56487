from repro_torch.kernels.gqa_decode.ops import (  # noqa: F401
    SPLIT_ROWS, gqa_decode, num_splits)
from repro_torch.kernels.gqa_decode.ref import (  # noqa: F401
    gqa_decode_ref, gqa_decode_split_ref)
