"""Telemetry of the port: metrics registry, spans, SLOs, energy meter,
Perfetto export (copies of the reference package's `repro/obs` modules),
and the port's own host spans (`host_spans`: wall-clock ranges around the
serving layers while a torch profiler runs)."""
from repro_torch.obs.energy import BankEnergyMeter, MeterReport
from repro_torch.obs.perfetto import (bank_state_events, chrome_trace_events,
                                      counter_integral, energy_counter_total,
                                      export_chrome_trace)
from repro_torch.obs.host_spans import HostSpan, host_registry, host_span
from repro_torch.obs.slo import (RequestTimeline, SLOSummary, SLOTracker,
                                 attach_energy_percentiles,
                                 percentile_summary, summarize_histograms)
from repro_torch.obs.telemetry import (DEFAULT_BUCKETS, LATENCY_BUCKETS,
                                       Counter, Gauge, Histogram, Span,
                                       Telemetry, default_registry,
                                       log_bucket_edges, noop_registry)

__all__ = [
    "Counter", "Gauge", "Histogram", "Span", "Telemetry",
    "DEFAULT_BUCKETS", "LATENCY_BUCKETS", "log_bucket_edges",
    "default_registry", "noop_registry",
    "RequestTimeline", "SLOSummary", "SLOTracker",
    "percentile_summary", "summarize_histograms",
    "chrome_trace_events", "counter_integral", "export_chrome_trace",
    "BankEnergyMeter", "MeterReport", "attach_energy_percentiles",
    "bank_state_events", "energy_counter_total",
    "HostSpan", "host_registry", "host_span",
]
