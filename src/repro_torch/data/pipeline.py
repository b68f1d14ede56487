"""Deterministic, resumable synthetic-token data pipeline (a copy of the
reference's `repro/data/pipeline.py`: numpy only, the same batches bit for
bit).

Batches are a pure function of (seed, step, shard) via counter-based Philox
RNG — no pipeline state to checkpoint: restoring a run at step N reproduces
exactly the batches a never-preempted run would have seen (the property the
fault-tolerance test asserts). A background prefetch thread hides generation
latency.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-ish structure so the LM loss actually decreases during examples
    structured: bool = True


class SyntheticTokens:
    """Shard-aware deterministic token stream."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        key = (np.uint64(c.seed) << np.uint64(32)) ^ np.uint64(0xD5)
        rng = np.random.Generator(np.random.Philox(
            key=[key, np.uint64(step) << np.uint64(16) | np.uint64(self.shard)]))
        B, S, V = self.local_batch, c.seq_len, c.vocab_size
        if not c.structured:
            toks = rng.integers(0, V, size=(B, S), dtype=np.int64)
        else:
            # piecewise-linear token ramps: learnable local structure
            start = rng.integers(0, V, size=(B, 1))
            stride = rng.integers(1, 17, size=(B, 1))
            noise = rng.integers(0, 2, size=(B, S))
            toks = (start + stride * np.arange(S)[None, :] + noise) % V
        batch = {"tokens": toks.astype(np.int32)}
        batch["labels"] = batch["tokens"]
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch with bounded queue; resumable via start_step."""

    def __init__(self, ds: SyntheticTokens, start_step: int = 0,
                 depth: int = 2):
        self.ds = ds
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.ds.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self.q.get()

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join()
