"""Fault-tolerant training loop; port of the reference's
`repro/train/loop.py`:

  * resume from the latest checkpoint on start (preemption recovery):
    with the stateless data pipeline a resumed run's parameters equal an
    uninterrupted run's, bit for bit;
  * asynchronous atomic checkpoints every `ckpt_every` steps;
  * a straggler monitor: a step slower than `straggler_factor` x the
    running median is flagged;
  * `fail_at_step` injects a failure (tests, examples).

The initial parameters are drawn by `init_params` from a `torch.Generator`
(a CPU one by default, so a run on the card starts from the CPU's
weights) and moved to the model's device.
"""
from __future__ import annotations

import collections
import os
import statistics
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from repro_torch.data import SyntheticTokens
from repro_torch.optim import AdamW
from repro_torch.optim.tree import tree_map
from repro_torch.params import init_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.step import make_train_step


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep_last: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    straggler_window: int = 20
    compression: str = "none"


@dataclass
class StragglerMonitor:
    factor: float = 3.0
    window: int = 20
    times: collections.deque = field(default_factory=lambda:
                                     collections.deque(maxlen=64))
    flagged: List[int] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) < self.window:
            return False
        med = statistics.median(self.times)
        if dt > self.factor * med:
            self.flagged.append(step)
            return True
        return False


class TrainLoop:
    def __init__(self, model, optimizer: AdamW, data: SyntheticTokens,
                 cfg: LoopConfig, *, fail_at_step: Optional[int] = None):
        self.model = model
        self.optimizer = optimizer
        self.data = data
        self.cfg = cfg
        self.fail_at_step = fail_at_step      # fault injection
        self.step_fn = make_train_step(model, optimizer, cfg.compression)
        self.monitor = StragglerMonitor(cfg.straggler_factor,
                                        cfg.straggler_window)
        self.ckpt = ckpt.AsyncCheckpointer(cfg.ckpt_dir, cfg.keep_last)
        self.history: List[Dict] = []

    def init_params(self, generator: Optional[torch.Generator] = None):
        """float32 parameters from `generator` (default: a CPU generator
        seeded 0), drawn on the generator's device and moved to the
        model's."""
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        params = init_params(self.model.cfg, gen, device=gen.device)
        return tree_map(lambda t: t.to(self.model.device), params)

    def run(self, generator: Optional[torch.Generator] = None
            ) -> Dict[str, Any]:
        params = self.init_params(generator)
        opt_state = self.optimizer.init(params)
        start = 0
        try:
            latest = ckpt.latest_step(self.cfg.ckpt_dir)
            if latest is not None:
                # preemption recovery: params + optimizer state + step
                state_like = {"params": params, "opt": opt_state}
                start, tree = ckpt.restore(self.cfg.ckpt_dir, state_like)
                params, opt_state = tree["params"], tree["opt"]

            for step in range(start, self.cfg.total_steps):
                if self.fail_at_step is not None \
                        and step == self.fail_at_step:
                    raise RuntimeError(f"injected failure at step {step}")
                batch = self.data.batch_at(step)
                t0 = time.perf_counter()
                params, opt_state, metrics = self.step_fn(params, opt_state,
                                                          batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                straggle = self.monitor.observe(step, dt)
                self.history.append({"step": step, "loss": loss,
                                     "time_s": dt, "straggler": straggle})
                if (step + 1) % self.cfg.ckpt_every == 0 \
                        or step + 1 == self.cfg.total_steps:
                    self.ckpt.save_async(step + 1,
                                         {"params": params, "opt": opt_state},
                                         metadata={"loss": loss})
        finally:
            self.ckpt.wait()
        return {"params": params, "opt_state": opt_state,
                "history": self.history,
                "stragglers": self.monitor.flagged}
