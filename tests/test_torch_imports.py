"""The port stands alone: no module of `repro_torch`, and not
`chip_smoke.py`, imports JAX or the JAX package `repro`, and the package
imports and runs a CPU prefill + paged decode step, a Stage-I decode
horizon swept in Stage II, a prefix-cached, chunked serve of shared-prefix
traffic with telemetry and an energy meter, a pruned, metered traffic
campaign, one reduced train step and an encoder-decoder served by
`BatchedServer` with its trace swept, with JAX made unimportable; the
dry run's modules (mesh, sharding, roofline, report) import without
touching `os.environ` or the process-group state."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return module in ("jax", "repro") or module.startswith(("jax.",
                                                            "repro."))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_forbidden_names_are_exact_modules():
    assert _forbidden("repro") and _forbidden("repro.core.gating")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert not _forbidden("repro_torch") and not _forbidden("repro_torch.x")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


SCRIPT = """
import sys
sys.modules["jax"] = None
import numpy as np, torch
import repro_torch
from repro_torch.configs import get_arch, reduced
from repro_torch.models import DecoderLM, init_paged_cache, write_prefill_to_pages
from repro_torch.params import init_params
cfg = reduced(get_arch("dsr1d-qwen-1.5b"), layers=2)
m = DecoderLM(cfg, compute_dtype=torch.float32, device="cpu")
p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
cache = init_paged_cache(cfg, 2, 8, 8, 3, dtype=torch.float32, device="cpu")
logits, dense = m.prefill(p, {"tokens": torch.arange(11)[None]}, 16)
write_prefill_to_pages(cfg, cache, dense, 0, torch.tensor([1, 2]))
tok = torch.zeros((2, 1), dtype=torch.long)
tok[0, 0] = int(logits[0, -1].argmax())
out, cache = m.decode_step_paged(p, cache, tok)
assert out.shape == (2, 1, cfg.padded_vocab) and bool(torch.isfinite(out).all())
assert cache["pos"].tolist() == [12, 0]
import repro_torch.launch.trapti, repro_torch.examples.quickstart
from repro_torch.core.explorer import sweep
from repro_torch.sim.accelerator import baseline_accelerator
from repro_torch.sim.pss import simulate_decode
sim = simulate_decode(cfg, baseline_accelerator(8), start_ctx=16, steps=8,
                      batch=2, subops=2, fidelity="pss")
assert sweep(sim, capacities_mib=[1], banks=(1, 4), device="cpu").rows
import repro_torch.examples.prefix_serving
from repro_torch.obs import BankEnergyMeter, Telemetry
from repro_torch.serve import PagedContinuousBatcher, Request
from repro_torch.traffic import chat_sysprompt, materialize_tokens
specs = chat_sysprompt(4.0, 2.0, seed=0, prefix_len=20, sharing=4)[:3]
cb = PagedContinuousBatcher(m, p, num_slots=2, page_size=8, num_pages=24,
                            max_pages_per_slot=11, chunk_steps=4,
                            prefix_cache=True, prefill_chunk_tokens=16,
                            telemetry=Telemetry(enabled=True),
                            meter=BankEnergyMeter(2**20, 4))
for s, t in zip(specs, materialize_tokens(specs, cfg.vocab_size)):
    cb.submit(Request(rid=s.rid, tokens=t[:80], max_new_tokens=3))
assert len(cb.run()) == 3 and cb.stats.prefix_hits >= 1
assert cb.slo_summary().n_requests == 3 and cb.meter.request_energy_j()
import repro_torch.launch.traffic, repro_torch.launch.obs
import repro_torch.examples.sla_serving, repro_torch.examples.traffic_gating
import repro_torch.examples.energy_attribution
import repro_torch.examples.obs_timeline
from repro_torch.traffic import run_campaign
rep = run_campaign(["dsr1d-qwen-1.5b"], horizon_s=2.0, num_slots=2,
                   max_len=256, banks=(1, 4), device="cpu", prune=True,
                   meter_spec="4,4")
assert rep.rows and rep.rows[0].energy is not None
import repro_torch.launch.train, repro_torch.examples.train_lm
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import EncDecModel
from repro_torch.optim import AdamW, constant
from repro_torch.train import make_train_step
from repro_torch.train import checkpoint
opt = AdamW(lr=constant(1e-3))
batch = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=2)).batch_at(0)
p2, st, met = make_train_step(m, opt)(p, opt.init(p), batch)
assert int(st.step) == 1 and bool(torch.isfinite(met["loss"]))
from repro_torch.examples.encdec_serving import (config, inputs, serve,
                                                 sweep_log)
ecfg = config(False)
em = EncDecModel(ecfg, compute_dtype=torch.float32, device="cpu")
ep = init_params(ecfg, torch.Generator().manual_seed(0), device="cpu")
fr, tk = inputs(ecfg, dict(batch=1, frames=6, prompt=5), 0)
res = serve(em, ep, fr, tk, 3)
assert res["tokens"].shape == (1, 3) and sweep_log(res["log"], "cpu").rows
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k, v in sys.modules.items() if v is not None)
print("ok")
"""


def test_port_runs_with_jax_unimportable():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", SCRIPT], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


MESH_MODULES = """
import os, sys
sys.modules["jax"] = None
env = dict(os.environ)
import torch.distributed as dist
import repro_torch.launch.dryrun, repro_torch.launch.mesh
import repro_torch.launch.roofline, repro_torch.launch.report
import repro_torch.models.sharding, repro_torch.models.meshctx
from repro_torch.models import batch_struct, cache_struct, cache_specs
from repro_torch.params import param_axes
assert dict(os.environ) == env
assert not dist.is_initialized()
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k, v in sys.modules.items() if v is not None)
print("ok")
"""


def test_mesh_modules_import_without_process_state():
    """The dry run's modules import without JAX and leave `os.environ` and
    the process-group state as they found them (the reference's dry run
    writes XLA_FLAGS at import)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", MESH_MODULES], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
