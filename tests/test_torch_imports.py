"""The port stands alone: no module of `repro_torch`, and not
`chip_smoke.py`, imports JAX or the JAX package `repro`, and the package
imports and runs a CPU prefill + paged decode step, and a Stage-I decode
horizon swept in Stage II, with JAX made unimportable."""
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
