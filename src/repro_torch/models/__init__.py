from repro_torch.models.encdec import EncDecModel  # noqa: F401
from repro_torch.models.factory import (  # noqa: F401
    batch_struct, build_model, cache_struct, concrete_batch)
from repro_torch.models.transformer import (  # noqa: F401
    DecoderLM, cache_specs, init_cache, init_paged_cache, self_spec_draft,
    write_prefill_to_pages)
