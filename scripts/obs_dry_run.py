"""CPU dry run of `chip_smoke.py`'s `traffic` and `serve_obs` phases: what
the card must print, computed without a card.

    PYTHONPATH=src python scripts/obs_dry_run.py

The traffic campaigns are host simulators with Stage II on the device, so
their rows, best (C, B) points, segment counts and peaks on the CPU are the
card's (its offline energies within rel 1e-12). It also counts the bank
kernels' launches the card's campaigns make, by counting calls of their
wrappers.

The instrumented serve's scheduling depends only on token counts when no
request has an EOS, and its clock is logical, so its counters, spans and
SLO percentiles do not depend on the model's weights or widths. This
script serves `chip_smoke.py`'s stream (the full vocabulary) through a
narrow model with the full model's KV geometry (28 layers, 2 KV heads of
128, bf16 pages), so that the page bytes, and with them the streamed
meter's energies, equal the full-width serve's too.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.kernels import bank_energy  # noqa: E402
from repro_torch.models import DecoderLM  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.traffic import run_campaign  # noqa: E402


def traffic() -> dict:
    """Each campaign's rows, best points, sims and the calls of the bank
    kernels' wrappers (kernel 3 = `exact_bank_stats` after one
    `running_time` scan, kernel 4 = `bank_activity_stats`)."""
    calls = {"running_time": 0, "exact_bank_stats": 0,
             "bank_activity_stats": 0}
    for name in calls:
        fn = getattr(bank_energy, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        setattr(bank_energy, name, counted)
    out = {}
    for tag, kw in smoke.CAMPAIGNS.items():
        rep = run_campaign(smoke.TRAFFIC_ARCHS, device="cpu", **smoke.TRAFFIC,
                           **kw)
        out[tag] = dict(
            rows=len(rep.rows),
            best={r.scenario.arch: (r.capacity_mib, r.banks)
                  for r in rep.best_per_scenario()},
            sims={arch: dict(
                segments=len(sim.trace.occupancy_series(sim.total_time)[0]),
                peak_mib=sim.trace.peak_needed() / 2**20)
                for (arch, _), sim in sorted(rep.sims.items())})
        if rep.rows[0].energy is not None:
            e = rep.rows[0].energy
            out[tag]["meter"] = dict(e_total_j=e.result.e_total,
                                     wakes=e.wakes,
                                     j_per_request=e.j_per_request)
    out["wrapper_calls"] = calls
    return out


def serve_obs() -> dict:
    full = get_arch(smoke.ARCH)
    cfg = dataclasses.replace(
        reduced(full, layers=full.num_layers), num_kv_heads=full.num_kv_heads,
        head_dim=full.head_dim, vocab_size=full.vocab_size,
        name=full.name + "-narrow")
    model = DecoderLM(cfg, torch.bfloat16, "cpu")
    params = init_params(cfg, torch.Generator().manual_seed(smoke.SEED),
                         device="cpu", dtype=torch.bfloat16)
    stream = smoke.obs_stream(full.vocab_size)
    cb, done, tel, meter, _, _ = smoke.obs_serve(model, params, stream, True)
    end = cb.occupancy_bundle().total_time
    res = meter.finalize(end)
    rep = meter.report(end)
    return dict(
        page_bytes=cb.page_bytes, prompt_lengths=[len(t) for t, _ in stream],
        mechanisms=smoke.mechanisms(cb.stats), chunks=cb.stats.chunks,
        counters=tel.snapshot()["counters"], spans=len(tel.spans),
        slo=vars(cb.slo_summary()),
        peak_pages=cb.ledger.trace.peak_needed() // cb.page_bytes,
        meter=dict(e_total_j=res.e_total, n_transitions=res.n_transitions,
                   wakes=meter.wake_counts(end),
                   j_per_request=rep.j_per_request,
                   floor_j=meter.floor_j(end)))


if __name__ == "__main__":
    print(json.dumps({"traffic": traffic()}, default=str))
    print(json.dumps({"serve_obs": serve_obs()}, default=str))
