"""Chrome-trace-event exporter: spans + occupancy traces on one timeline; a
copy of the reference package's `repro/obs/perfetto.py`.

Emits the JSON object format of the Trace Event spec (the dialect
ui.perfetto.dev and chrome://tracing load directly): request spans and
per-slot lanes as ``"X"`` complete events, zero-duration spans as ``"i"``
instants, and every Stage-I `OccupancyTrace` as a ``"C"`` counter track —
all in microseconds on the registry's clock. Because the serving batchers
record spans on the same logical sim clock their ledgers emit trace events
on, the KV-occupancy counter rises and falls in lockstep with the very
admissions/retirements drawn above it.

Lane (pid/tid) layout:

  * pid 1 "serving" — tid 1 "engine" (unclassified spans), tid 2
    "decode chunks", tid 10+i "slot i" (spans carrying a ``slot`` attr);
  * pid 2 "requests" — one lane per request id for ``request`` lifecycle
    spans (queue wait + streaming window end to end);
  * counter tracks attach to pid 1, one per occupancy trace, with
    ``needed``/``obsolete`` series stacked.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

import numpy as np

SERVING_PID = 1
REQUEST_PID = 2
BANKS_PID = 3

ENERGY_COUNTER = "bank energy [J]"
ACTIVE_COUNTER = "active banks"
_TID_ENGINE = 1
_TID_CHUNKS = 2
_TID_SLOT0 = 10


def _meta(pid: int, name: str, tid: Optional[int] = None) -> Dict:
    ev = {"ph": "M", "pid": pid,
          "name": "process_name" if tid is None else "thread_name",
          "args": {"name": name}}
    if tid is not None:
        ev["tid"] = tid
    return ev


def chrome_trace_events(telemetry=None, traces: Iterable = (),
                        *, end_time: Optional[float] = None,
                        meter=None) -> List[Dict]:
    """Build the trace-event list from a `Telemetry` registry's spans and
    any number of `OccupancyTrace`s (anything with ``mem_name`` and
    ``as_arrays()``). Times are seconds in, microseconds out. With a
    `BankEnergyMeter`, its bank-state timeline and energy counters ride
    along as pid-3 tracks (see `bank_state_events`)."""
    events: List[Dict] = [_meta(SERVING_PID, "serving")]
    used_tids: Dict[int, str] = {}
    req_tids: Dict[object, int] = {}

    spans = telemetry.spans if telemetry is not None else []
    for s in spans:
        attrs = s.attrs
        if s.name == "request" and "rid" in attrs:
            pid = REQUEST_PID
            rid = attrs["rid"]
            tid = req_tids.setdefault(rid, len(req_tids) + 1)
        else:
            pid = SERVING_PID
            if "slot" in attrs:
                tid = _TID_SLOT0 + int(attrs["slot"])
                used_tids.setdefault(tid, f"slot {attrs['slot']}")
            elif s.name == "decode_chunk":
                tid = _TID_CHUNKS
                used_tids.setdefault(tid, "decode chunks")
            else:
                tid = _TID_ENGINE
                used_tids.setdefault(tid, "engine")
        ev = {"name": s.name, "cat": "span", "pid": pid, "tid": tid,
              "ts": s.t0 * 1e6,
              "args": {k: v for k, v in attrs.items()}}
        if s.t1 > s.t0:
            ev["ph"] = "X"
            ev["dur"] = (s.t1 - s.t0) * 1e6
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        events.append(ev)

    for tid, name in sorted(used_tids.items()):
        events.append(_meta(SERVING_PID, name, tid))
    if req_tids:
        events.append(_meta(REQUEST_PID, "requests"))
        for rid, tid in req_tids.items():
            events.append(_meta(REQUEST_PID, f"request {rid}", tid))

    for tr in traces:
        t, n, o = tr.as_arrays()
        name = f"{tr.mem_name} occupancy [B]"
        for ti, ni, oi in zip(t, n, o):
            events.append({"ph": "C", "name": name, "pid": SERVING_PID,
                           "ts": float(ti) * 1e6,
                           "args": {"needed": int(ni), "obsolete": int(oi)}})
        if end_time is not None and len(t) and end_time > t[-1]:
            # hold the final level to the end of the timeline
            events.append({"ph": "C", "name": name, "pid": SERVING_PID,
                           "ts": float(end_time) * 1e6,
                           "args": {"needed": int(n[-1]),
                                    "obsolete": int(o[-1])}})

    if meter is not None:
        events.extend(bank_state_events(meter, end_time=end_time))

    # stable render order: metadata first, then strictly by timestamp
    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
    return events


def bank_state_events(meter, *, end_time: Optional[float] = None
                      ) -> List[Dict]:
    """Pid-3 tracks for a `BankEnergyMeter`: one ``\"X\"`` span lane per
    bank (state names active|idle|drowsy|gated), an active-bank-count
    counter (left segment edges, so `counter_integral` over it equals the
    timeline's bank-seconds) and a cumulative energy counter whose final
    sample is the meter's exact live total (f64 round-trips through JSON
    losslessly — `energy_counter_total` recovers it bit-identically)."""
    evs: List[Dict] = [_meta(BANKS_PID, "sram banks")]
    for b in range(meter.banks):
        evs.append(_meta(BANKS_PID, f"bank {b}", b + 1))
    for b, state, t0, t1 in meter.bank_intervals(end_time):
        evs.append({"ph": "X", "name": state, "cat": "bank",
                    "pid": BANKS_PID, "tid": int(b) + 1,
                    "ts": float(t0) * 1e6,
                    "dur": max(float(t1) - float(t0), 0.0) * 1e6,
                    "args": {"bank": int(b), "state": state}})
    t0s, durs, act = meter.activity_series(end_time)
    for t, a in zip(t0s, act):
        evs.append({"ph": "C", "name": ACTIVE_COUNTER, "pid": BANKS_PID,
                    "ts": float(t) * 1e6, "args": {"active": int(a)}})
    te, cum = meter.energy_series(end_time)
    for t, j in zip(te, cum):
        evs.append({"ph": "C", "name": ENERGY_COUNTER, "pid": BANKS_PID,
                    "ts": float(t) * 1e6, "args": {"cum_j": float(j)}})
    return evs


def energy_counter_total(events: List[Dict],
                         name: str = ENERGY_COUNTER,
                         series: str = "cum_j") -> float:
    """Final value of a cumulative counter track — the energy analogue of
    `counter_integral`: proves the exported track carries the meter's
    exact (bit-identical f64) live energy total."""
    pts = [(e["ts"], i, e["args"][series]) for i, e in enumerate(events)
           if e.get("ph") == "C" and e.get("name") == name]
    if not pts:
        return 0.0
    return float(max(pts)[2])


def counter_integral(events: List[Dict], name: str, end_time_us: float,
                     series: str = "needed") -> float:
    """∫ value·dt (byte·µs) of one counter track reconstructed from the
    exported events — the golden-format test checks this against
    `OccupancyTrace.time_integral` to prove the export lost nothing."""
    pts = [(e["ts"], e["args"][series]) for e in events
           if e.get("ph") == "C" and e.get("name") == name]
    if not pts:
        return 0.0
    ts = np.array([p[0] for p in pts])
    vs = np.array([p[1] for p in pts], np.float64)
    edges = np.append(ts, max(end_time_us, ts[-1]))
    return float((vs * np.diff(edges)).sum())


def export_chrome_trace(path: str, telemetry=None, traces: Iterable = (),
                        *, end_time: Optional[float] = None, meter=None,
                        other_data: Optional[Dict] = None) -> Dict:
    """Write a Perfetto-loadable trace file; returns the written object.

    `other_data` rides along under the spec's ``otherData`` key (ignored
    by the viewer) — the obs CLI stores the SLO summary there so smoke
    checks can assert on it without re-running the serve."""
    obj = {"traceEvents": chrome_trace_events(telemetry, traces,
                                              end_time=end_time,
                                              meter=meter),
           "displayTimeUnit": "ms"}
    if other_data:
        obj["otherData"] = other_data
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj
