"""Host spans: where the serving host's own time goes, recorded only while a
torch profiler session is live.

`host_span(name, **attrs)` is `Telemetry.span` for the host's wall clock.
With no profiler running it returns the shared no-op span after one flag
check (`torch.autograd._profiler_enabled`, about 0.1 µs): it enters no
profiler range and records nothing. While a `torch.profiler.profile`
session is live it enters the profiler's user range `name` (the range
`torch.profiler.record_function` enters, without its Python wrapper), so
the range sits in the Kineto trace beside the kernels it launched; on exit
it appends a :class:`HostSpan`, a `Span` on `time.perf_counter` whose
`parent` is the host span that was open when it began, to
:func:`host_registry`. That log holds at most `SPAN_CAP` spans; later ones
are counted by its `host_spans.dropped` counter, so a long profiled
session cannot grow without bound.

An operator gets the program's layers in any profile without a flag:

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]):
        batcher.run()
    spans = host_registry().spans      # HostSpan(name, t0, t1, attrs)

The spans the serving path opens (one thread drives the card):

    paged.admit         each `PagedContinuousBatcher._admit` call
    paged.decode_chunk  each decode chunk with a live slot
    paged.sync          the host reading device data (`at`: "first_token"
                        for an admission's first token and logits,
                        "chunk" for a chunk's tokens)
    paged.page_write    a prefill's KV rows scattered into pages
    model.prefill       `DecoderLM.prefill` and `prefill_shared`
    model.decode_step   `DecoderLM.decode_step_paged`
    model.attn, model.ffn  the two halves of a prefill or paged decode block
                        (a decode step replayed from a CUDA graph records
                        them only in the calls that run its body)

The batcher's `telemetry=` spans stay on its logical clock; these measure
the host."""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.obs.telemetry import _NULL_SPAN, Span, Telemetry

SPAN_CAP = 1 << 16

_profiling = torch.autograd._profiler_enabled
_range_enter = torch._C._autograd._record_function_with_args_enter
_range_exit = torch._C._autograd._record_function_with_args_exit


@dataclass
class HostSpan(Span):
    """A `Span` on the host's clock, with the host span that enclosed it
    (None at the top)."""
    parent: Optional["HostSpan"] = field(default=None, repr=False,
                                         compare=False)


_REGISTRY: Optional[Telemetry] = None
_open = threading.local()        # .span: the innermost open host span


def host_registry() -> Telemetry:
    """Process-wide log of host spans (spans on, `time.perf_counter`)."""
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = Telemetry(enabled=True, record_spans=True)
    return _REGISTRY


class _HostSpanCtx:
    __slots__ = ("_span", "_range")

    def __init__(self, name: str, attrs: dict):
        self._span = HostSpan(name, 0.0, 0.0, attrs)

    def __enter__(self):
        s = self._span
        s.parent = getattr(_open, "span", None)
        _open.span = s
        self._range = _range_enter(s.name)
        s.t0 = time.perf_counter()
        return s

    def __exit__(self, *exc):
        s = self._span
        s.t1 = time.perf_counter()
        _range_exit(self._range)
        _open.span = s.parent
        tel = host_registry()
        if len(tel.spans) < SPAN_CAP:
            tel.spans.append(s)
        else:
            tel.counter("host_spans.dropped").inc()
        return False


def host_span(name: str, **attrs):
    """``with host_span("paged.admit"): ...``: a profiler range and a
    `HostSpan` while a profiler is live; else the shared no-op span."""
    if not _profiling():
        return _NULL_SPAN
    return _HostSpanCtx(name, attrs)
