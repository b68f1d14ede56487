"""On the card, at each cell's own size: sound runs of the program pass the
cell's limits and the float8 control fails them, on three seeds. Run on a
machine with a card:

    PYTHONPATH=src python -m pytest -m gpu portbench/tests
"""
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cell_limits_at_cell_size(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.harness.serve import run_cell
    from portbench.harness.spec import load_cell
    cell = load_cell(ROOT, name)
    limits = cell.workload["check"]["limits"]
    for seed in SEEDS:
        r = run_cell(cell, seed, 15.0, False, device="cuda", control=True)
        assert r["correct"], (seed, r["checks"])
        assert any(r["control"][k] > limits[k] for k in r["control"]
                   if k in limits), (seed, r["control"])
