from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticTokens  # noqa: F401
