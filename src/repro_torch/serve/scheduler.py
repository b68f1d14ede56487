"""Scheduler types shared by the port's batchers: `Request`, the priority
`AdmissionQueue` and `SchedulerStats` (port of the reference's
`repro/serve/scheduler.py`). Telemetry timelines, SLO percentiles and the
energy meter are not ported yet."""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import numpy as np


@dataclass
class Request:
    rid: int
    tokens: np.ndarray                 # (prompt_len,)
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # admission class: higher admits first (FIFO within a class)
    priority: int = 0
    # filled by the scheduler
    output: List[int] = field(default_factory=list)
    # per-token last-position logits, filled only by batchers running with
    # collect_logits=True
    logits: List[np.ndarray] = field(default_factory=list)
    # lifecycle stamps on both clocks: `submitted_s`/`finished_s` are on the
    # engine's logical sim clock (the time base of the occupancy trace);
    # `*_wall_s` are time.perf_counter stamps for host-side profiling
    submitted_s: float = 0.0
    finished_s: float = 0.0
    submitted_wall_s: float = 0.0
    finished_wall_s: float = 0.0

    @property
    def latency_s(self) -> float:
        """Submit-to-finish on the engine's logical sim clock."""
        return self.finished_s - self.submitted_s

    @property
    def wall_latency_s(self) -> float:
        return self.finished_wall_s - self.submitted_wall_s


class AdmissionQueue:
    """Priority admission queue: descending `Request.priority`, FIFO within
    a class."""

    def __init__(self):
        self._heap: List = []
        self._seq = itertools.count()

    def push(self, req: Request) -> None:
        heapq.heappush(self._heap, (-req.priority, next(self._seq), req))

    def pop(self) -> Request:
        return heapq.heappop(self._heap)[2]

    def peek(self) -> Request:
        return self._heap[0][2]

    def __len__(self) -> int:
        return len(self._heap)

    def __iter__(self) -> Iterator[Request]:
        return (item[2] for item in sorted(self._heap))


@dataclass
class SchedulerStats:
    admitted: int = 0
    finished: int = 0
    decode_steps: int = 0
    prefills: int = 0
    peak_active_slots: int = 0
    admitted_kv_bytes: int = 0
    retired_kv_bytes: int = 0
