"""The dry run's abstract inputs and analytic roofline terms against the JAX
reference on the CPU, for every cell of `repro_torch.launch.dryrun.
all_cells` (the reference's cell list, copied):

* `factory.batch_struct` (meta tensors) has the keys, shapes and dtypes of
  the reference's `jax.ShapeDtypeStruct`s, for train, prefill and decode;
* `factory.cache_struct` has the tree, shapes and dtypes of the
  reference's `eval_shape` cache for every decode cell (the
  encoder-decoder's with its 4096-row memory);
* `roofline.model_flops` and `min_hbm_bytes` equal `repro.launch.roofline`
  (which imports no JAX) for every cell on 256 and 512 chips, and the
  port's constants are the H100's.
"""
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES, get_arch, shape_supported
from repro.launch import roofline as jax_roofline
from repro.models.factory import batch_struct as jax_batch_struct
from repro.models.factory import cache_struct as jax_cache_struct
import repro_torch.configs as tconfigs
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import all_cells
from repro_torch.models import batch_struct, cache_struct

ROOT = Path(__file__).resolve().parents[1]
CELLS = list(all_cells())


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.dtype(x.dtype).name


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


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            leaf for path, leaf in flat}


def test_cell_list_is_the_references():
    """The reference's 12 archs x their shapes (paper archs skip
    long_500k)."""
    assert len(CELLS) == 10 * 4 + 2 * 3
    assert {s for _, s in CELLS} == set(SHAPES)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_struct_is_the_references(arch, shape):
    cfg, tcfg = get_arch(arch), tconfigs.get_arch(arch)
    for kind in ("train", "prefill", "decode"):
        s = SHAPES[shape]
        ref_shape = type(s)(s.name, s.seq_len, s.global_batch, kind)
        ref = jax_batch_struct(cfg, ref_shape)
        port = batch_struct(tcfg, tconfigs.ShapeConfig(
            s.name, s.seq_len, s.global_batch, kind))
        assert list(port) == list(ref), kind
        for k, v in ref.items():
            assert port[k].device.type == "meta"
            assert tuple(port[k].shape) == tuple(v.shape), (kind, k)
            assert _dtype(port[k]) == _dtype(v), (kind, k)


@pytest.mark.parametrize("arch,shape", [c for c in CELLS
                                        if SHAPES[c[1]].kind == "decode"])
def test_cache_struct_is_the_references(arch, shape):
    cfg, tcfg = get_arch(arch), tconfigs.get_arch(arch)
    ref = _jax_leaves(jax_cache_struct(cfg, SHAPES[shape]))
    port = _port_leaves(cache_struct(tcfg, tconfigs.SHAPES[shape]))
    assert set(port) == set(ref)
    for path, v in ref.items():
        assert port[path].device.type == "meta"
        assert tuple(port[path].shape) == tuple(v.shape), path
        assert _dtype(port[path]) == _dtype(v), path


def test_cache_struct_refuses_other_kinds():
    with pytest.raises(ValueError):
        cache_struct(tconfigs.get_arch("gpt2-xl"), tconfigs.SHAPES["train_4k"])


@pytest.mark.parametrize("arch,shape", [
    c for c in CELLS if shape_supported(get_arch(c[0]), SHAPES[c[1]])[0]])
def test_model_flops_and_min_bytes_are_the_references(arch, shape):
    cfg, tcfg = get_arch(arch), tconfigs.get_arch(arch)
    s, ts = SHAPES[shape], tconfigs.SHAPES[shape]
    assert roofline.model_flops(tcfg, ts) == jax_roofline.model_flops(cfg, s)
    for chips in (1, 256, 512):
        assert roofline.min_hbm_bytes(tcfg, ts, chips) == \
            jax_roofline.min_hbm_bytes(cfg, s, chips)
        assert roofline.ideal_seconds(tcfg, ts, chips) == max(
            jax_roofline.model_flops(cfg, s) / chips / roofline.PEAK_FLOPS,
            jax_roofline.min_hbm_bytes(cfg, s, chips) / roofline.HBM_BW)


def test_roofline_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9
    tpu = re.compile(r"\b(197e12|819e9|50e9)\b")
    for name in ("roofline.py", "report.py"):
        text = (ROOT / "src" / "repro_torch" / "launch" / name).read_text()
        assert not tpu.search(text), name


def test_collective_bytes_sums_records_by_kind():
    out = roofline.collective_bytes([("all-reduce", 10.5), ("all-gather", 3),
                                     ("all-reduce", 4)])
    assert out == {"all-gather": 3, "all-reduce": 14, "reduce-scatter": 0,
                   "all-to-all": 0, "collective-permute": 0}
    with pytest.raises(ValueError):
        roofline.collective_bytes([("broadcast", 1)])
