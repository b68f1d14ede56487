"""Ambient mesh context so model code can apply sharding constraints without
threading a mesh through every call; port of the reference's
`repro/models/meshctx.py`. Outside `use_mesh`, and on plain tensors, the
constraints are no-ops: the port's models run on plain tensors, so serving
and the tests see no change; a DTensor is redistributed."""
from __future__ import annotations

import contextlib

from repro_torch.models import sharding
from repro_torch.models.sharding import Spec, mesh_axes

_CURRENT: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make `mesh` (a `DeviceMesh`, or any mesh `sharding.mesh_axes`
    reads) the current mesh inside the block."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh():
    return _CURRENT[-1] if _CURRENT else None


def fix_spec(shape, spec: Spec, mesh) -> Spec:
    """`spec` padded to len(shape), without the mesh axes `mesh` lacks (e.g.
    "pod" on the single-pod mesh) and without entries whose dim does not
    divide by their axes' size (the reference's `constrain`)."""
    sizes = mesh_axes(mesh)
    fixed = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is None:
            fixed.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a in sizes)
        size = 1
        for a in axes:
            size *= sizes[a]
        if not axes or dim % size != 0:
            fixed.append(None)
        else:
            fixed.append(axes if len(axes) > 1 else axes[0])
    return tuple(fixed)


def constrain(x, spec: Spec):
    """`x` redistributed to `spec` if a mesh is active and `x` is a DTensor
    (`sharding.constrain` on its own mesh, the spec first cut by
    `fix_spec`), else `x` itself."""
    if current_mesh() is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return sharding.constrain(x, mesh, fix_spec(x.shape, spec, mesh))
