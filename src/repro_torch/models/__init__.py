from repro_torch.models.encdec import EncDecModel  # noqa: F401
from repro_torch.models.factory import build_model, concrete_batch  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    DecoderLM, init_cache, init_paged_cache, self_spec_draft,
    write_prefill_to_pages)
