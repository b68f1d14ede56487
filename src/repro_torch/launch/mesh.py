"""Production and host meshes on torch's `DeviceMesh`; port of the
reference's `repro/launch/mesh.py`.

Functions, not module-level constants: importing this module touches no
process state (no process group, no environment variable), so tests and
the serving path that import it keep seeing none.

Production topology: one pod = 16 x 16 = 256 chips, axes ("data",
"model"); multi-pod adds a leading "pod" axis (2 x 256 = 512 chips).
Data parallelism spans ("pod", "data"), so the slowest (cross-pod)
collectives carry only gradient all-reduces, while tensor parallelism
stays inside a pod. A `DeviceMesh` needs a default process group of one
rank per device: `fake_world(n)` makes one of `n` ranks on a single host
with torch's fake backend (collectives do nothing), enough to place
tensors and read their local shards, which is what the dry run does.
"""
from __future__ import annotations

import contextlib
import math
import socket

import torch
import torch.distributed as dist

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod", "data",
    "model") with `multi_pod`, over the default process group, which must
    have 256 or 512 ranks (`fake_world`). Its device type is "cpu": the dry
    run places meta tensors on it and allocates on no device."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"the production mesh {dict(zip(axes, shape))} "
                           f"needs a process group of {n} ranks; run inside "
                           f"fake_world({n})")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


@contextlib.contextmanager
def fake_world(n: int):
    """A default process group of `n` ranks on this host (this process is
    rank 0) with torch's fake backend, destroyed on exit. Refuses to run
    inside another group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_host_mesh(device: str = "cuda"):
    """The degenerate (n, 1) ("data", "model") mesh over the devices that
    exist: n = `torch.cuda.device_count()` on the card, 1 on the CPU when
    asked. Without a process group it starts one of a single rank (NCCL
    on the card, gloo on the CPU, at a free localhost port), which then
    lives until `torch.distributed.destroy_process_group()`; more than one
    card needs one process per card, each in the group already."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.device import require_device
    dev = require_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"{n} devices: start one process per device "
                               "and initialise the process group first")
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}", rank=0,
            world_size=1)
    if dist.get_world_size() != n:
        raise RuntimeError(f"the process group has {dist.get_world_size()} "
                           f"ranks for {n} devices")
    return init_device_mesh(dev.type, (n, 1),
                            mesh_dim_names=("data", "model"))
