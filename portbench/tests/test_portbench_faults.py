"""The correctness check catches a broken timed path, and its control.

Each test drives a whole run of a tiny cell on the CPU (the harness's look
for a chip skipped, the program's plain PyTorch path underneath), with the
path broken, and sees `correct` come out false; the sound run comes out
true. The controls fail the tiny cells' limits: the reference computed
with float8 weight products fails `gap`, the program's own fp8 page path
fails `kv_err`. The tiny limits sit between readings at these sizes
(seeds 1, 2, 3 and 2**31 + 7, on the CPU): `gap` 0.016 for qwen2 (its LM
head untied), sound runs 0.00076 to 0.0073, the float8 reference 0.040 to
0.064; `gap` 0.008 for gpt2, sound runs 0 to 0.0011, the float8 reference
0.018 to 0.044; `kv_err` 0.01, bf16 pages 0.0029 to 0.0033, fp8 pages
0.0267 to 0.0274. The cells' own limits come from readings on the card
(PERF.md)."""
import dataclasses

import pytest

from portbench.harness.faults import half_batch, state_unchanged, token_altered
from portbench.harness.serve import run_cell
from portbench.tests.tiny import tiny_arch, tiny_cell

SEEDS = (1, 2, 3)
CYCLES = 12


def _run(family, seed, hook=None, control=False, kv_dtype="bf16"):
    cell = tiny_cell(family)
    cell = dataclasses.replace(cell,
                               config={**cell.config, "kv_dtype": kv_dtype})
    return run_cell(cell, seed, 0.0, False, device="cpu",
                    arch=tiny_arch(family), hook=hook, control=control,
                    cycles=CYCLES)


@pytest.mark.parametrize("family", ["qwen2", "gpt2"])
@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct_and_control_is_not(family, seed):
    r = _run(family, seed, control=True)
    assert r["correct"], r["checks"]
    assert r["control"]["gap"] > r["checks"]["gap"]["limit"]


@pytest.mark.parametrize("family", ["qwen2", "gpt2"])
@pytest.mark.parametrize("seed", SEEDS)
def test_fp8_pages_fail_kv_err(family, seed):
    c = _run(family, seed, kv_dtype="fp8")["checks"]["kv_err"]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("family", ["qwen2", "gpt2"])
@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   token_altered],
                         ids=lambda f: f.__name__)
def test_broken_path_is_not_correct(family, fault):
    r = _run(family, 2, hook=fault)
    assert not r["correct"], r["checks"]
