"""Reduction of a torch.profiler trace to what the metrics read: device
busy time (the union of device events, overlaps merged, as the port's
`chip_smoke.device_busy_ms` takes it) and device time and calls by kernel
name, from a profile of device activity alone; and the breakdown, from a
profile of host and device activity within the host-side label
`WINDOW`: the device operations that took most time, and the idle gaps
named by what the host was doing."""
from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "portbench.traced_window"
TOP = 10


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def device_time(events) -> Tuple[float, Dict[str, list]]:
    """Busy seconds (the union of the device events) and {kernel name:
    [seconds, calls]} of a profile taken with the device synchronized at
    both ends."""
    kernels: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    spans = []
    for n, is_dev, a, b in events:
        if is_dev:
            spans.append((a, b))
            kernels[n][0] += (b - a) / 1e6
            kernels[n][1] += 1
    busy = sum(b - a for a, b in _merge(spans)) / 1e6
    return busy, {n: list(v) for n, v in kernels.items()}


def breakdown(events) -> dict:
    """Within the `WINDOW` label: the device operations that took most
    time, and the idle time named by the innermost host operation running
    at each gap's midpoint, each the `TOP` largest."""
    win = [(a, b) for n, dev, a, b in events if not dev and n == WINDOW]
    if not win:
        raise RuntimeError(f"profile holds no {WINDOW!r} span")
    ws, we = win[0]
    dev, host = [], []
    ops: Dict[str, float] = defaultdict(float)
    for n, is_dev, a, b in events:
        if is_dev:
            a, b = max(a, ws), min(b, we)
            if b > a:
                dev.append((a, b))
                ops[n] += (b - a) / 1e6
        elif n != WINDOW:
            host.append((a, b, n))
    gaps, t = [], ws
    for a, b in _merge(dev):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if we > t:
        gaps.append((t, we))
    idle: Dict[str, float] = defaultdict(float)
    host.sort()
    # sweep the gaps' midpoints in order; the innermost running host op is
    # the latest-started one that has not ended (ops nest on a thread)
    running: list = []
    j = 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(running, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while running and running[0][1] < mid:
            heapq.heappop(running)
        name = running[0][2] if running else "host (no profiled op)"
        idle[name] += (b - a) / 1e6
    top = sorted(ops.items(), key=lambda x: -x[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in
                          sorted(idle.items(), key=lambda x: -x[1])[:TOP]]}


def profile_events(prof) -> list:
    """(name, is_device, start_us, end_us) of every event of a finished
    `torch.profiler.profile`, read from the raw Kineto events (building
    the profiler's event tree takes minutes on a traced window). Labels
    (`record_function`) count as host events only: their device-side
    copies span the label, not work."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        label = e.is_user_annotation()
        if e.is_hidden_event() or (label
                                   and e.device_type() != DeviceType.CPU):
            continue
        out.append((e.name(), e.device_type() == DeviceType.CUDA,
                    e.start_ns() / 1e3, e.end_ns() / 1e3))
    return out
