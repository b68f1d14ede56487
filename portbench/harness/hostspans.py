"""The program's host spans of the traced window, for the readers of
`prefill_issue_ms_per_ktok`, `decode_issue_ms`, `batcher_host_ms` and
`host_wait_share`.

While torch.profiler runs, the program logs wall-clock spans of its own
layers to `repro_torch.obs.host_spans.host_registry()` (admission, decode
chunk, the host's reads of device data, prefill and decode calls). A
traced run profiles `profile_cycles` cycles with device activity alone
(the traced window), then one more with host activity for the breakdown;
both leave spans. The window's spans are the top-level spans that began
by the end of its last prefill and last decode step, which the record
counts (`trace.prefill_S`, `trace.decode_rows`), and every span under
them. A program without host spans, or a run that logged none, gives
None."""
from __future__ import annotations

from typing import List, Optional

MODEL = "model."             # the model's code, prefix of its span names
SYNC = "paged.sync"          # the host waiting on the card for data
CYCLE = "paged.admit"        # one a cycle: `run` admits, then decodes
BATCHER = (CYCLE, "paged.decode_chunk")


def _log() -> list:
    try:
        from repro_torch.obs.host_spans import host_registry
    except ImportError:
        return []
    return list(host_registry().spans)


def root(s):
    while s.parent is not None:
        s = s.parent
    return s


def window(rec) -> Optional[List]:
    """The traced window's host spans, in order of start, or None."""
    tr = rec.get("trace")
    spans = _log()
    if not tr or not spans:
        return None
    spans = sorted(spans, key=lambda s: s.t0)
    ends = []
    for name, n in (("model.prefill", len(tr["prefill_S"])),
                    ("model.decode_step", len(tr["decode_rows"]))):
        calls = [s for s in spans if s.name == name]
        if n and len(calls) >= n:
            ends.append(calls[n - 1].t1)
    if not ends:
        return None
    t_end = max(ends)
    return [s for s in spans if root(s).t0 <= t_end]


def named(spans: list, name: str) -> list:
    return [s for s in spans if s.name == name]


def outer_cost(s) -> bool:
    """A model or sync span not inside another: time the batcher spent in
    the model's code or waiting on the card, not on its own work."""
    if not (s.name.startswith(MODEL) or s.name == SYNC):
        return False
    p = s.parent
    while p is not None:
        if p.name.startswith(MODEL) or p.name == SYNC:
            return False
        p = p.parent
    return True

