"""Multi-pod dry run on torch's DeviceMesh: prove the distribution config is
coherent for every (architecture x input shape) cell on the production
meshes, and derive memory, cost and roofline terms; port of the
reference's `repro/launch/dryrun.py`, which lowers and compiles each cell
with XLA. The port has no compiler that partitions a program, so a cell is
measured in two parts, inside `launch.mesh.fake_world(chips)` (a process
group of 256 or 512 ranks with torch's fake backend, nothing allocated on
any device; the same on any host):

* Placement. Every parameter leaf is placed as a DTensor on meta storage
  by the sharding rules (`models.sharding`): for train the fp32 master,
  AdamW's `m` and `v` and the step counter (TRAIN_RULES), for serving the
  bf16 weights (SERVE_RULES); also the batch (`batch_struct` over
  `batch_spec`) and, for decode and as prefill's output, the cache
  (`cache_struct` over `cache_specs`; the encoder-decoder's by
  `_encdec_cache_specs`). A placement that names a missing or reused mesh
  axis, or a dim its axes do not divide, is the cell's FAIL.
  `memory_analysis` sums the local shards' bytes per device: arguments,
  outputs and the aliased (donated) part, params and optimizer state in
  train and the cache in decode, as the reference donates them. It has no
  `temp_size_in_bytes`: the counting run below is unsharded and at probe
  depth, so its peak of live bytes is neither a per-device nor a
  full-depth figure.
* Cost. The plain step (train: `loss` then `backward()` under the cell's
  `remat`; prefill; `decode_step` with the cache's last row as position)
  runs under `FakeTensorMode` on CPU fake tensors at the cell's global
  batch and length, at 1 and 2 repetitions of the block pattern (full
  width). `FlopCounterMode` counts its FLOPs; `_ByteCounter` sums every
  aten op's operand and output bytes (views move nothing; an output that is
  one of the operands counts once). Both extrapolate linearly in depth, as
  the reference does (`:205-220`), and are divided by the chip count. This
  is an even-partition, unfused count of the plain program, not the
  per-device program a partitioner would emit: no op is fused, no
  activation is resharded, and attention materialises its scores.
* Collectives, per device, from the placements, by these rules and no
  others (ring volumes: for a group of n devices an all-gather or a
  reduce-scatter moves (n - 1)/n of the gathered bytes, an all-reduce
  twice that, 2 (n - 1)/n):
  - FSDP leaves (sharded over "data" in train: the "embed" dim): an
    all-gather of the leaf in forward and again in backward, then a
    reduce-scatter of its gradient, over "data";
  - leaves replicated over "data"/"pod" in train: an all-reduce of the
    gradient (its local shard) over the replicated axes;
  - each layer whose attention output ("wo", per attention module) or FFN
    down projection ("w_down") is sharded over "model": an all-reduce of
    its (B_local, S, D) bf16 activation over "model", in forward and, in
    train, again in backward;
  - decode with a sequence-sharded KV cache: per layer, an all-reduce of
    the per-row softmax statistics (max and sum, float32, B_local x heads
    rows) over the axis that shards the sequence.
* Roofline: `roofline.build_report(...).to_dict()` on the H100 constants,
  with `model_flops` and `min_hbm_bytes`.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import (ASSIGNED_ARCHS, PAPER_ARCHS, SHAPES,
                                 get_arch, shape_supported)
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import (EncDecModel, batch_struct, build_model,
                                cache_specs, cache_struct)
from repro_torch.models.sharding import (SERVE_RULES, TRAIN_RULES,
                                         batch_spec, mesh_axes, placements,
                                         spec_for)
from repro_torch.params import map_tree, param_axes, param_specs

ATTENTION_MODULES = ("attn", "self_attn", "cross_attn")


def _ring(n: int) -> float:
    return (n - 1) / n


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def _check_spec(spec, shape, sizes: Dict[str, int]) -> None:
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} has {len(spec)} entries for shape "
                         f"{tuple(shape)}")
    used = set()
    for entry, dim in zip(spec, shape):
        names = (entry if isinstance(entry, tuple)
                 else () if entry is None else (entry,))
        for name in names:
            if name not in sizes:
                raise ValueError(f"spec {spec}: no mesh axis {name!r}")
            if name in used:
                raise ValueError(f"spec {spec}: mesh axis {name!r} twice")
            used.add(name)
        if dim % math.prod(sizes[n] for n in names):
            raise ValueError(f"spec {spec}: dim {dim} of {tuple(shape)} "
                             f"does not divide by {names}")


def place(x: torch.Tensor, spec, mesh):
    """`x` (a meta tensor) as a DTensor on `mesh` by the spec tuple `spec`,
    after checking that the spec is legal for its shape."""
    from torch.distributed.tensor import distribute_tensor
    _check_spec(spec, x.shape, mesh_axes(mesh))
    return distribute_tensor(x, mesh, placements(spec, mesh))


def _local_bytes(tree) -> int:
    """Bytes of the local shards of a tree of DTensors."""
    return sum(_nbytes(x.to_local()) for x in _leaves(tree))


def _batch_specs(batch: Dict[str, torch.Tensor], mesh, kind: str):
    bspec = batch_spec(mesh, next(iter(batch.values())).shape[0], kind)
    return {k: bspec + (None,) * (v.ndim - 1) for k, v in batch.items()}


def _encdec_cache_specs(cache: Dict[str, Any], mesh):
    """The reference's `_encdec_cache_shardings`: the batch dim (1) over
    "data" and the head dim of K/V leaves over "model" where they divide."""
    sizes = mesh_axes(mesh)

    def f(leaf):
        spec = [None] * leaf.ndim
        if leaf.ndim >= 2:
            b = leaf.shape[1]
            if "data" in sizes and b % sizes["data"] == 0:
                spec[1] = "data"
        if leaf.ndim >= 5:
            if leaf.shape[-1] % sizes["model"] == 0:
                spec[-1] = "model"
        return tuple(spec)
    return {k: f(v) for k, v in cache.items()}


def _place_tree(tree, specs, mesh):
    return map_tree(specs, tree, lambda s, x, _: place(x, s, mesh))


def _param_tree(cfg, dtype, mesh, rules):
    """(placed params, their spec tree)."""
    shapes, axes = param_specs(cfg), param_axes(cfg)
    specs = map_tree(axes, shapes,
                     lambda a, s, _: spec_for(a, s[0], mesh, rules))
    placed = map_tree(specs, shapes, lambda sp, s, _: place(
        torch.empty(s[0], dtype=dtype, device="meta"), sp, mesh))
    return placed, specs


def _prefill_cache(cfg, shape):
    """The cache prefill returns: decode's at the prompt's length; an
    encoder-decoder's memory is the frames' length."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        cache = EncDecModel(cfg, device="meta").init_cache(B, S, S)
        cache["pos"] = torch.empty((), dtype=torch.int32, device="meta")
        return cache
    return cache_struct(cfg, dataclasses.replace(SHAPES["decode_32k"],
                                                 seq_len=S, global_batch=B))


def place_cell(cfg, shape, mesh) -> Dict[str, Any]:
    """Place a cell's arguments and outputs; returns the per-device byte
    sums of `memory_analysis` and the spec trees the collectives need."""
    kind = shape.kind
    rules = TRAIN_RULES if kind == "train" else SERVE_RULES
    dtype = torch.float32 if kind == "train" else torch.bfloat16
    params, pspecs = _param_tree(cfg, dtype, mesh, rules)
    p_bytes = _local_bytes(params)
    batch = batch_struct(cfg, shape)
    bspecs = _batch_specs(batch, mesh, kind)
    b_bytes = _local_bytes(_place_tree(batch, bspecs, mesh))
    out = {"pspecs": pspecs, "params": params, "bspecs": bspecs}
    V = cfg.padded_vocab
    if kind == "train":
        # AdamW: m and v shaped and placed as the fp32 master, the step an
        # int32 scalar replicated everywhere
        moments = 2 * p_bytes
        step = _nbytes(place(torch.empty((), dtype=torch.int32,
                                         device="meta"), (), mesh).to_local())
        state = p_bytes + moments + step
        ma = {"argument_size_in_bytes": state + b_bytes,
              "output_size_in_bytes": state + 4,        # + the loss
              "alias_size_in_bytes": state}
    else:
        cache = (_prefill_cache(cfg, shape) if kind == "prefill"
                 else cache_struct(cfg, shape))
        cspecs = (_encdec_cache_specs(cache, mesh) if cfg.is_encdec else
                  cache_specs(cfg, shape.global_batch, shape.seq_len, mesh))
        placed_cache = _place_tree(cache, cspecs, mesh)
        c_bytes = _local_bytes(placed_cache)
        B = shape.global_batch
        if kind == "prefill":
            logits = place(torch.empty((B, 1, V), dtype=torch.bfloat16,
                                       device="meta"), (None,) * 3, mesh)
            ma = {"argument_size_in_bytes": p_bytes + b_bytes,
                  "output_size_in_bytes": _nbytes(logits.to_local())
                  + c_bytes,
                  "alias_size_in_bytes": 0}
        else:
            logits = place(torch.empty((B, 1, V), dtype=torch.bfloat16,
                                       device="meta"),
                           bspecs["tokens"] + (None,), mesh)
            ma = {"argument_size_in_bytes": p_bytes + c_bytes + b_bytes,
                  "output_size_in_bytes": _nbytes(logits.to_local())
                  + c_bytes,
                  "alias_size_in_bytes": c_bytes}
        out.update(cspecs=cspecs, cache=placed_cache)
    out["memory_analysis"] = ma
    return out


# ---------------------------------------------------------------------------
# Cost: FLOPs and bytes of the plain step on fake tensors
# ---------------------------------------------------------------------------

class _ByteCounter(TorchDispatchMode):
    """Sums each aten op's operand and output bytes (views count nothing;
    an output that is one of its operands, as in-place ops return, counts
    once)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            outs = [t for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)
                    and not any(t is i for i in ins)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        return out


def _fake_inputs(cfg, shape):
    """The step's inputs as CPU tensors (made under the caller's
    `FakeTensorMode`): params, batch and, for decode, a full cache (the
    position at its last row)."""
    kind = shape.kind
    dtype = torch.float32 if kind == "train" else torch.bfloat16
    specs = param_specs(cfg)
    params = map_tree(specs, specs, lambda s, _, p: torch.empty(
        s[0], dtype=dtype, requires_grad=kind == "train"))
    batch = batch_struct(cfg, shape)
    batch = map_tree(batch, batch, lambda x, _, p: torch.zeros(
        x.shape, dtype=x.dtype))
    cache = None
    if kind == "decode":
        cache = cache_struct(cfg, shape)
        cache = map_tree(cache, cache, lambda x, _, p: torch.zeros(
            x.shape, dtype=x.dtype))
        cache["pos"] = shape.seq_len - 1
    return params, batch, cache


def count_step(cfg, shape, remat: str) -> Dict[str, float]:
    """FLOPs and bytes of one plain step of `cfg` (global, unsharded)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode():
        model = build_model(cfg, device="cpu", remat=remat)
        params, batch, cache = _fake_inputs(cfg, shape)
        flops = FlopCounterMode(display=False)
        nbytes = _ByteCounter()
        with flops, nbytes:
            if shape.kind == "train":
                model.loss(params, batch).backward()
            elif shape.kind == "prefill":
                model.prefill(params, batch, shape.seq_len)
            else:
                model.decode_step(params, cache, batch["tokens"])
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(nbytes.bytes)}


def _probe_cfg(cfg, n_groups: int):
    """Reduced-depth clone: n_groups pattern repetitions (full width)."""
    P_len = len(cfg.block_pattern)
    kw = {"num_layers": n_groups * P_len,
          "name": f"{cfg.name}-probe{n_groups}"}
    if cfg.is_encdec:
        kw["encoder_layers"] = n_groups
        kw["num_layers"] = n_groups
    # bypass the registry (probe configs are never registered)
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# Collectives by rule
# ---------------------------------------------------------------------------

def _named(spec) -> set:
    out = set()
    for entry in spec:
        if isinstance(entry, tuple):
            out.update(entry)
        elif entry is not None:
            out.add(entry)
    return out


def _layers(cfg, pspecs) -> List[Tuple[dict, int, str]]:
    """(block spec dict, layer count, what its activations run over:
    "tokens", or "frames" for the encoder's) per stack of blocks."""
    if cfg.is_encdec:
        return [(pspecs["encoder"], cfg.encoder_layers, "frames"),
                (pspecs["decoder"], cfg.num_layers, "tokens")]
    n_rep = cfg.num_layers // len(cfg.block_pattern)
    return ([(b, n_rep, "tokens") for b in pspecs["blocks"]]
            + [(b, 1, "tokens") for b in pspecs["tail"]])


def collective_records(cfg, shape, mesh, placed) -> List[Tuple[str, float]]:
    """(kind, bytes per device) of every collective the rules (module
    docstring) give for this cell's placements."""
    sizes = mesh_axes(mesh)
    kind = shape.kind
    recs: List[Tuple[str, float]] = []
    pspecs, params = placed["pspecs"], placed["params"]
    if kind == "train":
        dp = [a for a in ("pod", "data") if a in sizes]

        def grads(spec, leaf, _):
            local = _nbytes(leaf.to_local())
            named = _named(spec)
            if "data" in named:                       # FSDP
                n = sizes["data"]
                gathered = local * n
                recs.extend([("all-gather", _ring(n) * gathered)] * 2
                            + [("reduce-scatter", _ring(n) * gathered)])
            rep = math.prod(sizes[a] for a in dp if a not in named)
            if rep > 1:
                recs.append(("all-reduce", 2 * _ring(rep) * local))
        map_tree(pspecs, params, grads)
    bspec = placed["bspecs"]["tokens"][0]
    names = (bspec if isinstance(bspec, tuple)
             else () if bspec is None else (bspec,))
    b_local = shape.global_batch // math.prod(sizes[n] for n in names)
    seq = {"tokens": 1 if kind == "decode" else shape.seq_len,
           "frames": shape.seq_len}
    passes = 2 if kind == "train" else 1
    n_model = sizes["model"]
    for block, n_layers, over in _layers(cfg, pspecs):
        if kind == "decode" and over == "frames":
            continue                                  # no encoder in decode
        act = b_local * seq[over] * cfg.d_model * 2
        sharded = [m for m in ATTENTION_MODULES
                   if m in block and "model" in _named(block[m]["wo"])]
        ffn = block.get("ffn", {})
        downs = [ffn.get("w_down"), ffn.get("shared", {}).get("w_down")]
        if any(s is not None and "model" in _named(s) for s in downs):
            sharded.append("ffn")
        recs.extend([("all-reduce", 2 * _ring(n_model) * act)]
                    * (len(sharded) * n_layers * passes))
    if kind == "decode":
        cspecs, cache = placed["cspecs"], placed["cache"]
        kv = ([(cspecs["k"], cache["k"]), (cspecs["ck"], cache["ck"])]
              if cfg.is_encdec else
              [(e["k"], c["k"]) for e, c in zip(
                  cspecs["slots"] + cspecs["tail"],
                  cache["slots"] + cache["tail"]) if "k" in e])
        for spec, leaf in kv:
            seq_axis = spec[-3]
            if seq_axis is None:
                continue
            n = math.prod(sizes[a] for a in (
                seq_axis if isinstance(seq_axis, tuple) else (seq_axis,)))
            local = leaf.to_local().shape
            layers = local[0] if len(local) == 5 else 1
            stats = local[-4] * cfg.num_heads * 2 * 4
            recs.extend([("all-reduce", 2 * _ring(n) * stats)] * layers)
    return recs


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def lower_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
               remat: str = "full") -> Dict[str, Any]:
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    ok, reason = shape_supported(cfg, shape)
    mesh_label = "multi" if multi_pod else "single"
    cell = {"arch": arch_name, "shape": shape_name, "mesh": mesh_label}
    if not ok:
        cell["status"] = "SKIP"
        cell["reason"] = reason
        return cell
    chips = 512 if multi_pod else 256
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod)
        t0 = time.perf_counter()
        placed = place_cell(cfg, shape, mesh)
        records = collective_records(cfg, shape, mesh, placed)
        cell["compile_s"] = round(time.perf_counter() - t0, 1)
    cell["chips"] = chips
    peak = placed["memory_analysis"]
    cell["memory_analysis"] = peak

    t1 = time.perf_counter()
    c1 = count_step(_probe_cfg(cfg, 1), shape, remat)
    c2 = count_step(_probe_cfg(cfg, 2), shape, remat)
    n_groups = cfg.num_layers / len(cfg.block_pattern)
    if cfg.is_encdec:
        n_groups = cfg.num_layers  # enc+dec scale together in the probes
    total = {k: max(c1[k] + (n_groups - 1) * (c2[k] - c1[k]), 0.0)
             for k in c1}
    cell["probe_s"] = round(time.perf_counter() - t1, 1)
    cost = {"flops": total["flops"] / chips,
            "bytes accessed": total["bytes"] / chips}

    peak_bytes = (peak["argument_size_in_bytes"]
                  + peak["output_size_in_bytes"]
                  - peak["alias_size_in_bytes"])
    rep = rl.build_report(arch_name, shape_name, mesh_label, chips, cost,
                          records, rl.model_flops(cfg, shape),
                          peak_bytes,
                          min_bytes=rl.min_hbm_bytes(cfg, shape, chips))
    cell["roofline"] = rep.to_dict()
    cell["status"] = "OK"
    return cell


def all_cells(include_paper: bool = True):
    archs = list(ASSIGNED_ARCHS) + (list(PAPER_ARCHS) if include_paper else [])
    for a in archs:
        shapes = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
        if a in PAPER_ARCHS:
            shapes = ["train_4k", "prefill_32k", "decode_32k"]
        for s in shapes:
            yield a, s


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--remat", default="full")
    args = ap.parse_args()

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = (list(all_cells()) if args.all
             else [(args.arch, args.shape)])

    results = []
    for arch, shape in cells:
        for mp in meshes:
            try:
                cell = lower_cell(arch, shape, multi_pod=mp,
                                  remat=args.remat)
            except Exception as e:  # noqa: BLE001
                cell = {"arch": arch, "shape": shape,
                        "mesh": "multi" if mp else "single",
                        "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-2000:]}
            results.append(cell)
            r = cell.get("roofline", {})
            print(f"[{cell['status']:5s}] {arch:24s} {shape:12s} "
                  f"{cell['mesh']:6s} place={cell.get('compile_s', '-')}s "
                  f"count={cell.get('probe_s', '-')}s "
                  f"dom={r.get('dominant', '-')} "
                  f"useful={r.get('useful_flops_ratio', 0):.2f} "
                  f"roofl={r.get('roofline_fraction', 0)*100:.1f}% "
                  f"{cell.get('reason', '')}{cell.get('error', '')}",
                  flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
