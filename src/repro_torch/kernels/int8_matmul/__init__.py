from repro_torch.kernels.int8_matmul.ops import (  # noqa: F401
    int8_matmul, int8_matmul_acc, quantized_linear, split_k)
from repro_torch.kernels.int8_matmul.ref import (  # noqa: F401
    int8_matmul_acc_ref, int8_matmul_ref, quantize_cols, quantize_rows)
