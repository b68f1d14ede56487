from repro_torch.optim.adamw import AdamW, AdamWState, global_norm  # noqa: F401
from repro_torch.optim.schedule import cosine_with_warmup, constant  # noqa: F401
from repro_torch.optim.compression import (apply_compression, compress_bf16,  # noqa: F401
                                           compress_int8_ef, init_error_state)
