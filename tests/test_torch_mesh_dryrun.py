"""The port's dry run, report and host mesh, each in a subprocess of its own
(a process group is process-wide state, so none is started in the pytest
process):

* `python -m repro_torch.launch.dryrun` for dsr1d-qwen-1.5b `decode_32k`
  and gpt2-xl `train_4k` on the single-pod mesh: status OK on 256 chips,
  the per-device argument bytes equal to the local shard sizes recomputed
  here from `spec_for`, `batch_spec` and `cache_specs`, positive FLOPs,
  and collectives of the kinds the rules give, the reduce-scatter of
  gpt2-xl's FSDP leaves recomputed here too;
* `python -m repro_torch.launch.report` renders that JSON;
* `make_host_mesh("cpu")`: a (1, 1) mesh, `template_shardings` places the
  reduced dsr1d-qwen-1.5b's parameters on it, `constrain` and the windowed
  attention's `_constrain_chunks` redistribute DTensors as the reference's
  `constrain` would, and the reduced serve's tokens are the same under
  `use_mesh` as without it;
* `dryrun._check_spec` refuses an illegal placement.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch.configs as tconfigs
from repro_torch.launch.dryrun import _check_spec
from repro_torch.launch.roofline import COLLECTIVE_OPS
from repro_torch.models import cache_specs
from repro_torch.models.sharding import (SERVE_RULES, TRAIN_RULES,
                                         batch_spec, spec_for)
from repro_torch.params import param_axes, param_specs

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
CELLS = (("dsr1d-qwen-1.5b", "decode_32k"), ("gpt2-xl", "train_4k"))
SIZES = {"data": 16, "model": 16}


class Pod:
    shape = SIZES


def _run(args, timeout=120):
    r = subprocess.run([sys.executable, *args], env=ENV, cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """{(arch, shape): cell} from one CLI run per cell, and the JSON
    paths."""
    out, paths = {}, []
    for arch, shape in CELLS:
        path = tmp_path_factory.mktemp("dryrun") / f"{arch}_{shape}.json"
        _run(["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
              shape, "--mesh", "single", "--out", str(path)])
        (cell,) = json.loads(path.read_text())
        out[arch, shape] = cell
        paths.append(path)
    return out, paths


def _local(shape, spec) -> int:
    n = 1
    for dim, entry in zip(shape, spec):
        names = (entry if isinstance(entry, tuple)
                 else () if entry is None else (entry,))
        n *= dim // math.prod(SIZES[a] for a in names)
    return n


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _params(cfg, rules):
    """[(local elements, spec)] of every parameter leaf."""
    out = []
    for axes, (shape, _) in zip(_leaves(param_axes(cfg)),
                                _leaves(param_specs(cfg))):
        spec = spec_for(axes, shape, Pod, rules)
        out.append((_local(shape, spec), spec))
    return out


def test_decode_cell(dryrun):
    cell = dryrun[0]["dsr1d-qwen-1.5b", "decode_32k"]
    assert cell["status"] == "OK" and cell["chips"] == 256
    cfg, shape = (tconfigs.get_arch("dsr1d-qwen-1.5b"),
                  tconfigs.SHAPES["decode_32k"])
    B, T = shape.global_batch, shape.seq_len
    params = sum(n for n, _ in _params(cfg, SERVE_RULES)) * 2
    kv_shape = (cfg.num_layers, B, T, cfg.num_kv_heads, cfg.head_dim)
    specs = cache_specs(cfg, B, T, Pod)
    cache = sum(_local(kv_shape, specs["slots"][0][k]) * 2
                for k in ("k", "v")) + 4                 # + "pos"
    tokens = _local((B, 1), batch_spec(Pod, B, "decode") + (None,)) * 4
    ma = cell["memory_analysis"]
    assert ma["argument_size_in_bytes"] == params + cache + tokens
    assert ma["alias_size_in_bytes"] == cache
    r = cell["roofline"]
    assert r["chips"] == 256 and r["flops_per_device"] > 0
    assert r["bytes_per_device"] > 0
    # the cache is sequence-sharded over "model" (2 KV heads), and the
    # attention outputs and FFN down projections are sharded over "model":
    # all-reduces only
    assert specs["slots"][0]["k"][2] == "model"
    assert set(r["coll_breakdown"]) == set(COLLECTIVE_OPS)
    assert r["coll_breakdown"]["all-reduce"] > 0
    assert all(v == 0 for k, v in r["coll_breakdown"].items()
               if k != "all-reduce")


def test_train_cell(dryrun):
    cell = dryrun[0]["gpt2-xl", "train_4k"]
    assert cell["status"] == "OK" and cell["chips"] == 256
    cfg, shape = tconfigs.get_arch("gpt2-xl"), tconfigs.SHAPES["train_4k"]
    leaves = _params(cfg, TRAIN_RULES)
    state = sum(n for n, _ in leaves) * 4 * 3 + 4        # master, m, v, step
    B, S = shape.global_batch, shape.seq_len
    batch = 2 * _local((B, S), batch_spec(Pod, B, "train") + (None,)) * 4
    ma = cell["memory_analysis"]
    assert ma["argument_size_in_bytes"] == state + batch
    assert ma["alias_size_in_bytes"] == state
    r = cell["roofline"]
    assert r["flops_per_device"] > 0
    coll = r["coll_breakdown"]
    # FSDP leaves (the "embed" dim over "data"): one reduce-scatter of the
    # gradient and two all-gathers of the leaf, (n - 1)/n of the gathered
    # fp32 bytes each
    fsdp = sum(n * 4 * 16 * 15 / 16 for n, spec in leaves if "data" in spec)
    assert fsdp > 0
    assert coll["reduce-scatter"] == pytest.approx(fsdp, rel=1e-6)
    assert coll["all-gather"] == pytest.approx(2 * fsdp, rel=1e-6)
    assert coll["all-reduce"] > 0
    assert coll["all-to-all"] == 0 and coll["collective-permute"] == 0


def test_report_renders_the_dry_run(dryrun):
    for path in dryrun[1]:
        text = _run(["-m", "repro_torch.launch.report", str(path)])
        assert "cells: OK=1 SKIP=0 FAIL=0" in text
        assert "## §Roofline" in text and "| single |" in text


def test_check_spec_refuses_illegal_placements():
    _check_spec(("data", "model"), (32, 48), SIZES)
    for spec, shape in (((None, "pod"), (4, 4)), (("model", "model"), (16,
                                                                        16)),
                        (("data",), (24,)), (("data",), (16, 16))):
        with pytest.raises(ValueError):
            _check_spec(spec, shape, SIZES)


HOST_MESH = """
import sys
sys.modules["jax"] = None
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from repro_torch.configs import get_arch, reduced
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import DecoderLM
from repro_torch.models.attention import _constrain_chunks
from repro_torch.models.meshctx import constrain, use_mesh
from repro_torch.models.sharding import SERVE_RULES, template_shardings
from repro_torch.params import init_params, map_tree, param_axes, param_specs
from repro_torch.serve import BatchedServer, ServeConfig
assert not dist.is_initialized()
mesh = make_host_mesh("cpu")
assert mesh.mesh.shape == (1, 1) and mesh.device_type == "cpu"
assert mesh.mesh_dim_names == ("data", "model")
cfg = reduced(get_arch("dsr1d-qwen-1.5b"), layers=2)
params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
pl = template_shardings(param_axes(cfg), param_specs(cfg), mesh, SERVE_RULES)
placed = map_tree(pl, params, lambda p, x, _: distribute_tensor(x, mesh, p))
def leaves(t):
    if isinstance(t, dict):
        return [y for v in t.values() for y in leaves(v)]
    if isinstance(t, list):
        return [y for v in t for y in leaves(v)]
    return [t]
for x, d in zip(leaves(params), leaves(placed)):
    assert isinstance(d, DTensor) and torch.equal(d.to_local(), x)
x = distribute_tensor(torch.ones(4, 4), mesh, [Replicate(), Replicate()])
with use_mesh(mesh):
    y = constrain(x, (("pod", "data"), "model"))
assert tuple(y.placements) == (Shard(0), Shard(1)), y.placements
g = torch.Generator().manual_seed(0)
qc, kc = (distribute_tensor(torch.randn(s, generator=g), mesh,
                            [Replicate(), Replicate()])
          for s in ((2, 3, 4, 2, 3, 8), (2, 3, 4, 2, 8)))
with use_mesh(mesh):
    cq, ck, cv = _constrain_chunks(qc, kc, kc)
assert tuple(cq.placements) == (Shard(0), Shard(2)), cq.placements
for c in (ck, cv):
    assert tuple(c.placements) == (Shard(0), Replicate()), c.placements
assert torch.equal(cq.full_tensor(), qc.full_tensor())
assert torch.equal(ck.full_tensor(), kc.full_tensor())
model = DecoderLM(cfg, compute_dtype=torch.float32, device="cpu")
prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
def serve():
    srv = BatchedServer(model, params, ServeConfig(max_len=32,
                                                   max_new_tokens=4))
    return srv.generate({"tokens": prompts})["tokens"]
plain = serve()
with use_mesh(mesh):
    meshed = serve()
assert np.array_equal(plain, meshed)
dist.destroy_process_group()
print("ok")
"""


def test_host_mesh_places_the_reduced_model_and_keeps_its_tokens():
    out = _run(["-c", HOST_MESH])
    assert out.strip().endswith("ok")
