from repro_torch.kernels.gqa_decode.ops import gqa_decode  # noqa: F401
from repro_torch.kernels.gqa_decode.ref import gqa_decode_ref  # noqa: F401
