"""Telemetry of the port: the metrics registry (`obs.telemetry`, a copy of
the reference's). The SLO tracker, the energy meter and the Perfetto export
are not ported yet."""
from repro_torch.obs.telemetry import (DEFAULT_BUCKETS,  # noqa: F401
                                       LATENCY_BUCKETS, Counter, Gauge,
                                       Histogram, Span, Telemetry,
                                       default_registry, log_bucket_edges,
                                       noop_registry)
