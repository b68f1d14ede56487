"""Stage II: offline SRAM banking + power-gating design-space exploration
(port of the reference's `repro/core/explorer.py`).

Reuses a Stage-I occupancy trace (fixed execution schedule) to sweep
(capacity C, bank count B, headroom alpha, policy) and emit the paper's
artifacts: Table II/III banking tables, Fig 8 bank-activity timelines, and
the Fig 9 energy-area Pareto scatter.

Sweeps are thin wrappers over the batched candidate-evaluation engine
(`core.candidates.evaluate_candidates`): the whole grid is evaluated in one
call, optionally prune-then-exact (`prune=True`), on `device` (the CUDA
bank-energy kernels on the card, their plain versions on the CPU). The
input is a Stage-I `SimResult` (the simulator's, `occupancy_kind="needed"`,
`mem_name="sram"`) or a `TraceBundle` (the paged batcher's
`occupancy_bundle()`, `mem_name="kv"`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.core.candidates import Candidate, evaluate_candidates
from repro_torch.core.gating import GatingResult, Policy
from repro_torch.sim.engine import SimResult
from repro_torch.sim.trace import TraceBundle

MIB = 2**20
DEFAULT_BANKS = (1, 2, 4, 8, 16, 32)

# Anything exposing .graph_name / .total_time / .traces / .access satisfies
# Stage II's input contract: the Stage-I SimResult, or a TraceBundle.
TraceSource = Union[SimResult, TraceBundle]


@dataclass
class SweepRow:
    capacity_mib: int
    banks: int
    result: GatingResult
    delta_e_pct: float = 0.0      # vs B=1 at same capacity
    delta_a_pct: float = 0.0


@dataclass
class SweepTable:
    workload: str
    mem_name: str
    alpha: float
    rows: List[SweepRow] = field(default_factory=list)

    def best(self) -> SweepRow:
        return min(self.rows, key=lambda r: r.result.e_total)

    def format(self) -> str:
        lines = [f"# {self.workload} / {self.mem_name}  (alpha={self.alpha})",
                 f"{'C[MiB]':>7} {'B':>3} {'E[mJ]':>12} {'A[mm2]':>9} "
                 f"{'dE%':>7} {'dA%':>7} {'E_dyn':>9} {'E_leak':>9} "
                 f"{'E_sw':>9} {'Nsw':>6}"]
        for r in self.rows:
            g = r.result
            lines.append(
                f"{r.capacity_mib:>7} {r.banks:>3} {g.e_total*1e3:>12.1f} "
                f"{g.area_mm2:>9.2f} {r.delta_e_pct:>+7.1f} "
                f"{r.delta_a_pct:>+7.1f} {g.e_dyn*1e3:>9.1f} "
                f"{g.e_leak*1e3:>9.1f} {g.e_sw*1e3:>9.3f} "
                f"{g.n_transitions:>6}")
        return "\n".join(lines)


def min_capacity_mib(peak_needed_bytes: int, step_mib: int = 16) -> int:
    """Paper's rounding: peak requirement rounded up to the 16 MiB grid."""
    return step_mib * math.ceil(peak_needed_bytes / (step_mib * MIB))


def _policy_candidate(cap: int, b: int, policy: Policy) -> Candidate:
    """Stage-II convention: B=1 cannot gate, so it runs the no-gating
    baseline at the sweep's alpha."""
    pol = policy if b > 1 else Policy.none(policy.alpha)
    return Candidate(cap, b, pol.alpha, "gate" if pol.gate else "none",
                     pol.min_gate_multiple, label=pol.name)


def sweep(sim: TraceSource, *, mem_name: str = "sram",
          capacities_mib: Optional[Sequence[int]] = None,
          banks: Sequence[int] = DEFAULT_BANKS,
          policy: Optional[Policy] = None,
          max_capacity_mib: int = 128,
          occupancy_kind: str = "needed",
          device="cuda", prune: bool = False) -> SweepTable:
    """Sweep (C, B) for one memory of one Stage-I run (or a trace bundle —
    e.g. the paged batcher's, with mem_name="kv").

    `occupancy_kind="needed"`: only retention-required bytes pin banks —
    obsolete data needs no retention, so its banks are gate-eligible (this is
    the reading under which the paper's Fig. 8 occupancy curve fluctuates
    well below capacity).

    The whole grid is one `evaluate_candidates` call; with `prune=True` only
    the lower-bound survivors (plus each capacity's delta baseline) are
    evaluated exactly, and pruned rows are omitted from the table.
    """
    policy = policy or Policy.conservative()
    trace = sim.traces[mem_name]
    dur, occ = trace.occupancy_series(sim.total_time, use=occupancy_kind)
    n_r = sim.access.n_reads(mem_name)
    n_w = sim.access.n_writes(mem_name)

    if capacities_mib is None:
        lo = min_capacity_mib(trace.peak_needed())
        capacities_mib = list(range(lo, max_capacity_mib + 1, 16)) or [lo]
    caps_kept = [c for c in capacities_mib if c * MIB >= trace.peak_needed()]
    if not caps_kept:
        return SweepTable(sim.graph_name, mem_name, policy.alpha)

    base_b = min(banks)
    cands, meta, baselines = [], [], []
    for c_mib in caps_kept:
        for b in banks:
            if b == base_b:
                baselines.append(len(cands))
            meta.append((c_mib, b))
            cands.append(_policy_candidate(c_mib * MIB, b, policy))
    res = evaluate_candidates(dur, occ, cands, n_reads=n_r, n_writes=n_w,
                              device=device, prune=prune,
                              always_evaluate=baselines)

    table = SweepTable(sim.graph_name, mem_name, policy.alpha)
    # delta baseline: the smallest bank count present (B=1 when swept; the
    # smallest banked config otherwise — never a silent 0.0)
    base_by_cap: Dict[int, GatingResult] = {
        meta[i][0]: res.gating_result(i) for i in baselines}
    for i, (c_mib, b) in enumerate(meta):
        if not res.evaluated[i]:
            continue
        g = res.gating_result(i)
        row = SweepRow(c_mib, b, g)
        base = base_by_cap[c_mib]
        if base.e_total > 0:
            row.delta_e_pct = 100.0 * (g.e_total / base.e_total - 1.0)
            row.delta_a_pct = 100.0 * (g.area_mm2 / base.area_mm2 - 1.0)
        table.rows.append(row)
    return table


def pareto_points(tables: Sequence[SweepTable]):
    """Fig.-9 scatter: (area, energy, label) for every (C,B) candidate."""
    pts = []
    for t in tables:
        for r in t.rows:
            pts.append((r.result.area_mm2, r.result.e_total, t.workload,
                        r.capacity_mib, r.banks))
    return pts


def alpha_sensitivity(sim: TraceSource, *, capacity_mib: int, banks: int,
                      alphas: Sequence[float] = (1.0, 0.9, 0.75, 0.5),
                      mem_name: str = "sram",
                      device="cuda") -> Dict[float, GatingResult]:
    """Fig.-8 support: how alpha moves bank activity / energy at fixed (C,B).
    One batched call over the alpha axis, on `device`."""
    trace = sim.traces[mem_name]
    dur, occ = trace.occupancy_series(sim.total_time, use="needed")
    n_r = sim.access.n_reads(mem_name)
    n_w = sim.access.n_writes(mem_name)
    cands = [Candidate(capacity_mib * MIB, banks, a, "gate", 5.0,
                       label="conservative") for a in alphas]
    res = evaluate_candidates(dur, occ, cands, n_reads=n_r, n_writes=n_w,
                              device=device)
    return {a: res.gating_result(i) for i, a in enumerate(alphas)}
