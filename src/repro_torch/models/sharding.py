"""Logical-axis sharding rules with divisibility fallback; port of the
reference's `repro/models/sharding.py` onto torch's `DeviceMesh` and
DTensor placements.

Every parameter leaf carries logical axis names (`params.param_axes`). A
rule table maps logical names to an ordered list of mesh-axis candidates; a
candidate is used only when the dim divides evenly by the mesh axis size and
the mesh axis is not already taken by another dim of the same tensor. This
is what lets qwen2's 28 query heads shard under 16-way tensor parallelism:
the packed projection dim (heads * head_dim = 3584) shards though 28 does
not.

A spec is a plain tuple with one entry per dim: None, a mesh-axis name, or a
tuple of names (sharded over their product, the first name major), the
reference's `PartitionSpec` entries. `spec_for`, `template_pspecs` and
`batch_spec` take any `mesh` whose axes `mesh_axes` can read: a `DeviceMesh`
(its `mesh_dim_names` and sizes) or an object with a `.shape` mapping of
axis name to size, as the reference's tests use. `template_shardings` and
`placements` turn specs into DTensor placements on a `DeviceMesh`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.params import map_tree

Spec = Tuple[Optional[object], ...]

# Candidate mesh axes per logical axis, in preference order. Entries may be
# tuples (meaning shard over the product of those mesh axes).
TRAIN_RULES = {
    "batch":      [("pod", "data"), ("data",)],
    "seq":        [],                     # sequence kept unsharded in train
    "embed":      [("data",)],            # FSDP: weights sharded over data
    "vocab":      [("model",)],
    "heads":      [("model",)],
    "kv_heads":   [("model",)],
    "head_dim":   [],
    "qkv_out":    [("model",)],           # packed q/k/v projection output
    "mlp":        [("model",)],
    "experts":    [("model",)],
    "layers":     [],
    "seq_table":  [],
    "state":      [],
    "conv":       [],
    "lru":        [("model",)],
    "ssm_inner":  [("model",)],
}

SERVE_RULES = {
    **TRAIN_RULES,
    "batch":      [("data",), ("pod", "data")],
    "embed":      [],                     # no FSDP at serving time
    # decode KV cache: prefer kv-head sharding, fall back to head_dim
    "kv_heads":   [("model",)],
    "head_dim":   [],
    "kv_seq":     [("data",)],            # context parallelism for long decode
}


@dataclass(frozen=True)
class Rules:
    table: dict
    # head_dim may be sharded as a fallback when kv_heads doesn't divide
    kv_head_dim_fallback: bool = True


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size of a `DeviceMesh` or of a `.shape`-mapping mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def axis_size(mesh, axes) -> int:
    shape = mesh_axes(mesh)
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= shape[a]
    return n


def spec_for(tpl_axes: Sequence[str], shape: Sequence[int], mesh,
             rules: dict) -> Spec:
    sizes = mesh_axes(mesh)
    used: set = set()
    out = []
    for name, dim in zip(tpl_axes, shape):
        choice = None
        for cand in rules.get(name, []):
            cand_t = cand if isinstance(cand, tuple) else (cand,)
            if any(c in used for c in cand_t):
                continue
            if all(c in sizes for c in cand_t) \
                    and dim % axis_size(mesh, cand_t) == 0:
                choice = cand_t if len(cand_t) > 1 else cand_t[0]
                used.update(cand_t)
                break
        out.append(choice)
    return tuple(out)


def template_pspecs(template_axes, shapes, mesh, rules: dict):
    """The tree of spec tuples for a tree of axis names (`param_axes`) and
    the matching tree of (shape, init) leaves (`param_specs`)."""
    return map_tree(template_axes, shapes,
                    lambda axes, leaf, _: spec_for(axes, leaf[0], mesh,
                                                   rules))


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of a spec tuple on a `DeviceMesh`: per mesh
    dimension, `Shard(dim)` where the spec names that mesh axis on tensor
    dim `dim`, else `Replicate()`. A dim sharded over a tuple of mesh axes
    is split by the first axis first, as the reference's PartitionSpec
    splits it."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for dim, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple)
                     else (() if entry is None else (entry,))):
            where[name] = dim
    return tuple(Shard(where[name]) if name in where else Replicate()
                 for name in mesh.mesh_dim_names)


def template_shardings(template_axes, shapes, mesh, rules: dict):
    """The tree of DTensor placements (a tuple per leaf, one placement per
    mesh dimension) of `template_pspecs` on a `DeviceMesh`."""
    return map_tree(template_axes, shapes,
                    lambda axes, leaf, _: placements(
                        spec_for(axes, leaf[0], mesh, rules), mesh))


# ---------------------------------------------------------------------------
# Activation constraints
# ---------------------------------------------------------------------------

def batch_spec(mesh, global_batch: int, kind: str) -> Spec:
    """Sharding spec for the leading batch dim of activations/inputs."""
    sizes = mesh_axes(mesh)
    rules = TRAIN_RULES if kind == "train" else SERVE_RULES
    for cand in rules["batch"]:
        if all(c in sizes for c in cand) \
                and global_batch % axis_size(mesh, cand) == 0:
            return (cand if len(cand) > 1 else cand[0],)
    return (None,)


def constrain(x, mesh, spec: Spec):
    """`x` redistributed to `spec` on `mesh` (the reference's
    `with_sharding_constraint`); a plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    return x.redistribute(mesh, placements(spec, mesh))
