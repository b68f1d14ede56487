"""Batched Stage-II candidate-evaluation engine (port of the reference's
`repro/core/candidates.py`).

One vectorized call computes the **exact** Eq. (2)-(5) energy for a full
(capacity C x banks B x headroom alpha x policy) candidate grid against one
occupancy trace — including threshold gating and the three-state drowsy
policy — replacing the per-candidate / per-bank Python loops in
the scalar references `core.gating.evaluate` and
`core.sensitivity.evaluate_drowsy`.

The heavy lifting is idle-run extraction in `kernels.bank_energy`: the
CUDA kernels on the card, their plain float64 PyTorch versions on the
CPU. On top of the exact path, `evaluate_candidates(prune=True)` runs a two-phase flow: the cheap
per-candidate energy lower bound (required-bank leakage + dynamic energy,
no idle-run extraction) cuts the grid first, and only survivors — those
whose lower bound does not exceed the incumbent's exact energy — are
evaluated exactly. Since bound <= exact under every policy, the true argmin
is never dropped.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cacti import characterize
from repro_torch.core.gating import GatingResult
from repro_torch.core.sensitivity import (DROWSY_LEAK_FRACTION,
                                          DROWSY_SWITCH_FRACTION, DrowsyResult)
from repro_torch.device import require_device

POLICIES = ("none", "gate", "drowsy")

# exact_bank_stats columns
_ACT_S, _N_LONG, _LONG_S, _N_SHORT, _SHORT_S = range(5)


@dataclass(frozen=True)
class Candidate:
    """One cell of the Stage-II grid.

    policy: "none" (no gating), "gate" (two-state threshold gating — the
    paper's conservative/aggressive policies are alpha/threshold settings of
    this), "drowsy" (three-state ON/DROWSY/OFF retention policy).
    `min_gate_multiple` is the gate threshold (or drowsy off-threshold) in
    units of the break-even time; `e_switch_scale` is the sensitivity hook
    scaling transition energy and break-even together."""
    capacity: int
    banks: int
    alpha: float = 0.9
    policy: str = "gate"
    min_gate_multiple: float = 1.0
    e_switch_scale: float = 1.0
    label: str = ""

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}")
        if not (0.0 < self.alpha <= 1.0):
            raise ValueError(f"alpha must be in (0,1], got {self.alpha}")

    @property
    def usable_bytes(self) -> float:
        # same op order as banking.bank_activity, for bit-equal ceil()
        return self.alpha * (self.capacity / self.banks)


def make_grid(capacities_bytes: Sequence[int], banks: Sequence[int],
              alphas: Sequence[float] = (0.9,),
              policies: Sequence[str] = ("gate",),
              min_gate_multiple: float = 1.0) -> List[Candidate]:
    """Dense (C x B x alpha x policy) grid, C-major like `candidate_grid`."""
    return [Candidate(int(c), int(b), float(a), p, min_gate_multiple)
            for c in capacities_bytes for b in banks
            for a in alphas for p in policies]


@dataclass
class CandidateEnergies:
    """Column-per-observable result of one batched evaluation.

    For pruned-out candidates (`evaluated[i] == False`) `e_total[i]` holds
    the energy *lower bound*, not the exact energy; `best()`/`argmin()` only
    rank exactly-evaluated candidates."""
    candidates: List[Candidate]
    e_dyn: np.ndarray
    e_leak: np.ndarray               # total leakage (ON + drowsy retention)
    e_sw: np.ndarray
    e_leak_on: np.ndarray
    e_leak_drowsy: np.ndarray
    n_off: np.ndarray                # full power-gate transitions
    n_drowsy: np.ndarray             # drowsy transitions (drowsy policy only)
    gated_bank_seconds: np.ndarray
    total_bank_seconds: np.ndarray
    area_mm2: np.ndarray
    evaluated: np.ndarray            # bool; False -> e_total is a lower bound
    lower_bound: np.ndarray
    e_total: np.ndarray = field(init=False)

    def __post_init__(self):
        self.e_total = self.e_dyn + self.e_leak + self.e_sw

    def __len__(self) -> int:
        return len(self.candidates)

    def argmin(self) -> int:
        masked = np.where(self.evaluated, self.e_total, np.inf)
        if not self.evaluated.any():
            raise ValueError("no exactly-evaluated candidates")
        return int(np.argmin(masked))

    def best(self) -> Tuple[Candidate, float]:
        i = self.argmin()
        return self.candidates[i], float(self.e_total[i])

    # ------------------------------------------------- scalar-result views
    def _require_evaluated(self, i: int) -> None:
        if not self.evaluated[i]:
            raise ValueError(
                f"candidate {i} was pruned by the lower bound; only "
                f"e_total[{i}] (the bound itself) is meaningful")

    def gating_result(self, i: int) -> GatingResult:
        self._require_evaluated(i)
        c = self.candidates[i]
        return GatingResult(
            policy=c.label or c.policy, alpha=c.alpha, capacity=c.capacity,
            banks=c.banks, e_dyn=float(self.e_dyn[i]),
            e_leak=float(self.e_leak[i]), e_sw=float(self.e_sw[i]),
            n_transitions=int(self.n_off[i]),
            gated_bank_seconds=float(self.gated_bank_seconds[i]),
            total_bank_seconds=float(self.total_bank_seconds[i]),
            area_mm2=float(self.area_mm2[i]))

    def drowsy_result(self, i: int) -> DrowsyResult:
        self._require_evaluated(i)
        return DrowsyResult(
            e_dyn=float(self.e_dyn[i]), e_leak_on=float(self.e_leak_on[i]),
            e_leak_drowsy=float(self.e_leak_drowsy[i]),
            e_sw=float(self.e_sw[i]), n_off=int(self.n_off[i]),
            n_drowsy=int(self.n_drowsy[i]))


def _characteristics(cands: Sequence[Candidate]):
    """Per-candidate device constants, via the memoized CACTI surrogate."""
    chs = [characterize(c.capacity, c.banks, c.e_switch_scale) for c in cands]
    return (np.array([ch.leak_w_per_bank for ch in chs]),
            np.array([ch.e_read_j for ch in chs]),
            np.array([ch.e_write_j for ch in chs]),
            np.array([ch.e_switch_j for ch in chs]),
            np.array([ch.break_even_s for ch in chs]),
            np.array([ch.area_mm2 for ch in chs]))


def lower_bound_energies(durations, occupancy, cands: Sequence[Candidate], *,
                         n_reads: int, n_writes: int,
                         device="cuda") -> np.ndarray:
    """Per-candidate energy lower bound in one cheap batched call:
    dynamic energy + leakage of the banks the occupancy *requires*. Valid
    under every policy (required leakage and accesses are unavoidable;
    switching and timer/retention leakage are >= 0), which makes it safe
    for pruning. Runs the `bank_energy` kernel on `device` (its plain
    version when `device` is the CPU)."""
    from repro_torch.kernels.bank_energy import bank_activity_stats
    dev = require_device(device)
    p_leak, e_r, e_w, _, _, _ = _characteristics(cands)
    usable = np.array([c.usable_bytes for c in cands])
    nbanks = np.array([float(c.banks) for c in cands])
    stats = bank_activity_stats(_on(durations, dev), _on(occupancy, dev),
                                _on(usable, dev), _on(nbanks, dev))
    seconds = stats[:, 0].cpu().numpy()
    return n_reads * e_r + n_writes * e_w + p_leak * seconds


def _on(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64), device=dev)


def evaluate_candidates(durations, occupancy, cands: Sequence[Candidate], *,
                        n_reads: int, n_writes: int, device="cuda",
                        prune: bool = False, prune_margin: float = 1e-3,
                        always_evaluate: Optional[Sequence[int]] = None
                        ) -> CandidateEnergies:
    """Exact batched Stage-II evaluation of every candidate, on `device`
    (the `exact_bank_stats` kernel on the card, its plain float64 version on
    the CPU).

    With `prune=True`, candidates whose lower bound exceeds the incumbent's
    exact energy (best-lower-bound candidate, evaluated exactly first) by
    more than `prune_margin` (relative) are skipped; their rows carry the
    lower bound and `evaluated=False`. `always_evaluate` lists indices
    exempt from pruning (e.g. a sweep's delta baselines). The trace's
    running time is computed once and serves both exact calls."""
    return _evaluate(durations, occupancy, list(cands), n_reads=n_reads,
                     n_writes=n_writes, dev=require_device(device),
                     prune=prune, prune_margin=prune_margin,
                     always_evaluate=always_evaluate, cum=None)


def _evaluate(durations, occupancy, cands: List[Candidate], *, n_reads: int,
              n_writes: int, dev: torch.device, prune: bool,
              prune_margin: float, always_evaluate: Optional[Sequence[int]],
              cum: Optional[torch.Tensor]) -> CandidateEnergies:
    """`evaluate_candidates` on `dev`; `cum` is the trace's running time
    on `dev` once computed (None before)."""
    from repro_torch.kernels.bank_energy import exact_bank_stats, running_time
    n = len(cands)
    d = np.asarray(durations, np.float64)
    occ = np.asarray(occupancy, np.float64)
    total_time = float(d.sum())
    if cum is None and len(d) and any(c.policy != "none" for c in cands):
        cum = running_time(_on(d, dev))

    p_leak, e_r, e_w, e_sw_j, break_even, area = _characteristics(cands)
    e_dyn = n_reads * e_r + n_writes * e_w
    nbanks_f = np.array([float(c.banks) for c in cands])
    total_bank_seconds = nbanks_f * total_time

    lb = np.full(n, -np.inf)
    evaluated = np.ones(n, bool)
    if prune and n > 1:
        lb = lower_bound_energies(d, occ, cands, n_reads=n_reads,
                                  n_writes=n_writes, device=dev)
        incumbent_i = int(np.argmin(lb))
        inc = _evaluate(d, occ, [cands[incumbent_i]], n_reads=n_reads,
                        n_writes=n_writes, dev=dev, prune=False,
                        prune_margin=prune_margin, always_evaluate=None,
                        cum=cum)
        cutoff = float(inc.e_total[0]) * (1.0 + prune_margin)
        evaluated = lb <= cutoff
        evaluated[incumbent_i] = True
        for i in (always_evaluate or ()):
            evaluated[i] = True

    need = [i for i in range(n)
            if evaluated[i] and cands[i].policy != "none"]
    stats = np.zeros((n, 5))
    if need and len(d):
        usable = np.array([cands[i].usable_bytes for i in need])
        nb = np.array([float(cands[i].banks) for i in need])
        th = np.array([cands[i].min_gate_multiple for i in need]) \
            * break_even[need]
        stats[need] = exact_bank_stats(
            _on(d, dev), _on(occ, dev), _on(usable, dev), _on(nb, dev),
            _on(th, dev), cum=cum).cpu().numpy()
    pol = np.array([POLICIES.index(c.policy) for c in cands])
    is_none, is_gate, is_drowsy = pol == 0, pol == 1, pol == 2

    act_s = stats[:, _ACT_S]
    n_off = np.where(is_none, 0.0, stats[:, _N_LONG])
    off_s = stats[:, _LONG_S]
    n_short = stats[:, _N_SHORT]
    short_s = stats[:, _SHORT_S]

    # leakage: none -> all banks all the time; gate -> everything except
    # gated (long-idle) runs; drowsy -> ON while required + retention
    # fraction during short idles
    e_leak_on = np.where(
        is_none, p_leak * total_bank_seconds,
        np.where(is_gate, p_leak * (total_bank_seconds - off_s),
                 p_leak * act_s))
    e_leak_drowsy = np.where(is_drowsy,
                             p_leak * DROWSY_LEAK_FRACTION * short_s, 0.0)
    e_sw = np.where(
        is_none, 0.0,
        n_off * e_sw_j + np.where(
            is_drowsy, n_short * e_sw_j * DROWSY_SWITCH_FRACTION, 0.0))
    n_drowsy = np.where(is_drowsy, n_short, 0.0)
    gated = np.where(is_none, 0.0, off_s)

    out = CandidateEnergies(
        candidates=cands, e_dyn=e_dyn, e_leak=e_leak_on + e_leak_drowsy,
        e_sw=e_sw, e_leak_on=e_leak_on, e_leak_drowsy=e_leak_drowsy,
        n_off=n_off.astype(np.int64), n_drowsy=n_drowsy.astype(np.int64),
        gated_bank_seconds=gated, total_bank_seconds=total_bank_seconds,
        area_mm2=area, evaluated=evaluated, lower_bound=lb)
    # pruned rows report their lower bound so ranking stays informative
    pruned = ~evaluated
    if pruned.any():
        out.e_leak[pruned] = 0.0
        out.e_sw[pruned] = 0.0
        out.e_total = np.where(pruned, lb, out.e_total)
    return out
