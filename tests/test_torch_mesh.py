"""Parity of the port's sharding rules with the JAX reference on the CPU:

* `params.param_axes` leaf for leaf against the reference template's
  `PTpl.axes`, for every registry config, reduced (the reference's
  `build_model(cfg).template()`) and at full width (with the shapes of
  `param_specs`);
* `sharding.spec_for` / `template_pspecs` under both rule sets, and
  `batch_spec` and `transformer.cache_specs` for every registry config and
  shape, on `FakeMesh` shapes {data 16, model 16} and {pod 2, data 16,
  model 16}: the port's tuples equal the reference's `PartitionSpec`
  entries; the four `FakeMesh` cases of the reference's
  `tests/test_sharding.py`;
* `meshctx`: `constrain` is the identity without a mesh and on plain
  tensors, `fix_spec` drops missing and indivisible axes as the
  reference's `constrain` does, and the windowed decoders' tokens are
  unchanged under `use_mesh` of a (1, 1) mesh.

Nothing here starts a process group; the meshes are `.shape` mappings.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES, get_arch, list_archs, reduced
from repro.models import build_model as jax_build_model
from repro.models import sharding as jsh
from repro.models.common import PTpl
from repro.models.transformer import cache_specs as jax_cache_specs
import repro_torch.configs as tconfigs
from repro_torch.models import DecoderLM, cache_specs
from repro_torch.models import sharding as tsh
from repro_torch.models.meshctx import (constrain, current_mesh, fix_spec,
                                        use_mesh)
from repro_torch.params import init_params, param_axes, param_specs

ARCHS = list_archs()
RULES = {"train": (jsh.TRAIN_RULES, tsh.TRAIN_RULES),
         "serve": (jsh.SERVE_RULES, tsh.SERVE_RULES)}


class Pod:
    shape = {"data": 16, "model": 16}


class MultiPod:
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"single": Pod, "multi": MultiPod}


def _jax_leaves(tree):
    """path -> leaf of a reference tree of PTpl or PartitionSpec leaves."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (PTpl, P)))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            leaf for path, leaf in flat}


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, path + (k,)))
    return out


def _templates(name):
    """(reference template, port config) at reduced and full width."""
    cfg = get_arch(name)
    out = []
    for c in (reduced(cfg), cfg):
        tc = tconfigs.get_arch(name) if c is cfg else tconfigs.reduced(
            tconfigs.get_arch(name))
        out.append((jax_build_model(c).template(), tc))
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_param_axes_are_the_references(name):
    for tpl, tcfg in _templates(name):
        ref = _jax_leaves(tpl)
        axes = _port_leaves(param_axes(tcfg))
        shapes = {k: v[0] for k, v in _port_leaves(param_specs(tcfg)).items()}
        assert set(axes) == set(ref)
        for path, leaf in ref.items():
            assert axes[path] == tuple(leaf.axes), path
            assert shapes[path] == tuple(leaf.shape), path
            assert len(axes[path]) == len(shapes[path])


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_template_pspecs_are_the_references(name, mesh):
    m = MESHES[mesh]
    for tpl, tcfg in _templates(name):
        for jrules, trules in RULES.values():
            ref = _jax_leaves(jsh.template_pspecs(tpl, m, jrules))
            port = _port_leaves(tsh.template_pspecs(
                param_axes(tcfg), param_specs(tcfg), m, trules))
            assert set(port) == set(ref)
            for path, spec in ref.items():
                assert port[path] == tuple(spec), path


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_spec_is_the_references(mesh):
    m = MESHES[mesh]
    for batch in sorted({s.global_batch for s in SHAPES.values()}
                        | {1, 2, 8, 32, 48, 512, 1024}):
        for kind in ("train", "prefill", "decode"):
            assert tsh.batch_spec(m, batch, kind) == \
                tuple(jsh.batch_spec(m, batch, kind)), (batch, kind)


@pytest.mark.parametrize("name", [n for n in ARCHS
                                  if not get_arch(n).is_encdec])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_specs_are_the_references(name, mesh):
    m = MESHES[mesh]
    cfg, tcfg = get_arch(name), tconfigs.get_arch(name)
    for shape in SHAPES.values():
        for batch in (shape.global_batch, 1, 8):
            ref = _jax_leaves(jax_cache_specs(cfg, batch, shape.seq_len, m))
            port = _port_leaves(cache_specs(tcfg, batch, shape.seq_len, m))
            assert set(port) == set(ref)
            for path, spec in ref.items():
                assert port[path] == tuple(spec), (shape.name, batch, path)


def test_reference_fake_mesh_cases():
    """The `FakeMesh` cases of the reference's `tests/test_sharding.py`."""
    assert tsh.spec_for(("heads",), (28,), Pod, tsh.TRAIN_RULES) == (None,)
    assert tsh.spec_for(("qkv_out",), (3584,), Pod,
                        tsh.TRAIN_RULES) == ("model",)

    class Small:
        shape = {"data": 4, "model": 4}
    assert tsh.spec_for(("vocab", "mlp"), (64, 64), Small,
                        tsh.TRAIN_RULES) == ("model", None)
    assert tsh.batch_spec(MultiPod, 256, "train") == (("pod", "data"),)
    assert tsh.batch_spec(MultiPod, 2, "train") == (None,)


def test_constrain_is_identity_without_a_mesh_or_on_plain_tensors():
    assert current_mesh() is None
    x = torch.ones((4, 4))
    assert constrain(x, ("data", None)) is x
    with use_mesh(Pod) as m:
        assert current_mesh() is m
        assert constrain(x, (("pod", "data"), "model")) is x
    assert current_mesh() is None


def test_fix_spec_drops_missing_axes_and_indivisible_dims():
    assert fix_spec((32, 4, 16), (("pod", "data"), "model", "model"),
                    Pod) == ("data", None, "model")
    assert fix_spec((64, 3), (("pod", "data"),), MultiPod) == \
        (("pod", "data"), None)
    assert fix_spec((1, 16), ("data", None, "model"), Pod) == (None, None)

    class Unit:
        shape = {"data": 1, "model": 1}
    assert fix_spec((4, 4), (("pod", "data"), None), Unit) == ("data", None)


def _greedy(model, params, prompt, steps):
    logits, cache = model.prefill(params, {"tokens": prompt},
                                  prompt.shape[1] + steps)
    out = []
    for _ in range(steps):
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        out.append(tok)
        logits, cache = model.decode_step(params, cache, tok)
    return torch.cat(out, 1), logits


@pytest.mark.parametrize("name", ["recurrentgemma-2b",
                                  "llama4-scout-17b-a16e"])
def test_windowed_decoder_tokens_unchanged_under_a_unit_mesh(name):
    """The windowed layers call `constrain`; under a (1, 1) mesh on plain
    tensors the tokens and logits are bit for bit the mesh-free run's."""
    cfg = tconfigs.reduced(tconfigs.get_arch(name),
                           layers=len(tconfigs.get_arch(name).block_pattern))
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    model = DecoderLM(cfg, compute_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    W = cfg.local_window
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 2 * W)),
                          dtype=torch.int32)

    class Unit:
        shape = {"data": 1, "model": 1}
    plain = _greedy(model, params, prompt, 3)
    with use_mesh(Unit):
        meshed = _greedy(model, params, prompt, 3)
    assert torch.equal(plain[0], meshed[0])
    assert torch.equal(plain[1], meshed[1])
