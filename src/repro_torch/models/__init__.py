from repro_torch.models.transformer import (  # noqa: F401
    DecoderLM, init_paged_cache, write_prefill_to_pages)
