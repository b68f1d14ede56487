"""What the benchmark may import: no module under `portbench/` has `jax`,
`jaxlib`, `flax` or the JAX package `repro` as its top-level import name
(compared whole: `repro_torch` is the port), and the plain reference
imports nothing of the program. A run in a directory that holds only the
benchmark's files, or on a host without a card, prints no result."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = FORBIDDEN & set(_imports(f))
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        mods = set(_imports(f))
        assert not mods & (FORBIDDEN | {"repro_torch", "portbench"}), f
        assert mods <= {"__future__", "math", "dataclasses", "typing",
                        "torch"}, f


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(ROOT))
    try:
        from portbench.run import forbidden_modules
    finally:
        sys.path.remove(str(ROOT))
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_lookalike"] = sys
        assert "repro_torch_lookalike" not in forbidden_modules()
        sys.modules["repro.sim"] = sys
        assert forbidden_modules() == ["repro"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def _run(cwd: Path, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "gpt2-xl.doc-prefill", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure it")
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_no_result_from_the_benchmark_files_alone(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in bench["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout == ""
