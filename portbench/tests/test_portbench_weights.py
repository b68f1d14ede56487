"""The harness's weights: the same seed gives the same weights, and the
program's view of them has the program's parameter tree, at the full
configurations' sizes (shapes only) and at reduced ones."""
import json
from pathlib import Path

import pytest
import torch

from portbench.harness.serve import program_arch
from portbench.harness.weights import _leaves, make_weights, program_params
from portbench.reference.decoder import shape_of
from portbench.tests.tiny import tiny_arch, tiny_config

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def _spec_shapes(tree):
    if isinstance(tree, dict):
        return {k: _spec_shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_shapes(v) for v in tree]
    return tuple(tree[0])


@pytest.mark.parametrize("name", ["dsr1d-qwen-1.5b", "gpt2-xl"])
def test_full_configs_give_the_program_tree(name):
    from repro_torch.params import param_specs
    conf = json.loads((CONFIGS / f"{name}.json").read_text())
    arch = program_arch(conf)
    shape = shape_of(conf)
    meta = {n: torch.empty(s, device="meta", dtype=torch.bfloat16)
            for n, s, _, _ in _leaves(shape, arch.padded_vocab)}
    assert _shapes(program_params(arch, meta)) == \
        _spec_shapes(param_specs(arch))


def test_program_arch_refuses_a_file_that_differs():
    conf = json.loads((CONFIGS / "dsr1d-qwen-1.5b.json").read_text())
    conf["intermediate_size"] = 4480
    with pytest.raises(ValueError, match="d_ff"):
        program_arch(conf)


@pytest.mark.parametrize("family", ["qwen2", "gpt2"])
def test_weights_repeat_per_seed_and_gains_cross_exactly(family):
    arch, shape = tiny_arch(family), shape_of(tiny_config(family))
    a = make_weights(shape, 2 ** 31 + 3, "cpu", rows=arch.padded_vocab)
    b = make_weights(shape, 2 ** 31 + 3, "cpu", rows=arch.padded_vocab)
    c = make_weights(shape, 7, "cpu", rows=arch.padded_vocab)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wq"], c["wq"])
    p = program_params(arch, a)
    n1 = p["blocks"][0]["norm1"]["scale"]
    if family == "qwen2":      # the program stores gain - 1: exact
        assert torch.equal(1.0 + n1.float(), a["ln1_g"].float())
    else:
        assert n1 is a["ln1_g"]
    assert p["embed"]["tok"] is a["embed"]
