"""Meshes of the port (the counterpart of ``repro/launch/mesh.py``), built
on ``torch.distributed.device_mesh.init_device_mesh`` with named dims.

Functions, never module-level constants: importing this module touches no
process group.  A mesh covers the ranks of the default process group: the
production meshes need a world of 256 (``multi_pod``: 512) ranks, which a
real cluster gives or, in ``launch/dryrun.py`` only, a fake group does; the
host mesh covers the world that exists, one rank (one card) when the
caller has started none.
"""
from __future__ import annotations

import math
import os
import socket

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

POD_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


def production_world(multi_pod: bool = False) -> int:
    """The ranks the production mesh needs: 256 (16×16), 512 with pods."""
    return math.prod(MULTI_POD_SHAPE if multi_pod else POD_SHAPE)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16×16 = 256 chips per pod; 2 pods = 512 chips when multi_pod.
    Raises unless the default process group has exactly that world."""
    shape = MULTI_POD_SHAPE if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise RuntimeError(f"the production mesh {shape} needs a world of "
                           f"{need} ranks, not {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def ensure_process_group(device_type: str = "cuda") -> bool:
    """Start the default process group when none exists (NCCL for the
    card, gloo for the CPU): from the environment a launcher such as
    ``torchrun`` sets (``WORLD_SIZE`` > 1, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), else one rank with its store on a free localhost
    port.  Returns True when it started one (the caller destroys it)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device_type == "cuda" else "gloo"
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(backend, init_method="env://")
        return True
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    return True


def make_host_mesh(model_axis: int = 1,
                   device_type: str = "cuda") -> DeviceMesh:
    """(world / model_axis, model_axis) over the default process group's
    ranks: (1, 1) on one card.  Needs a process group (see
    ``ensure_process_group``)."""
    n = dist.get_world_size()
    assert n % model_axis == 0
    return init_device_mesh(device_type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, name: str) -> int:
    return mesh.size(axis_names(mesh).index(name))


def data_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (the pod axis folds into DP)."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def dp_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in data_axes(mesh))


def tp_size(mesh) -> int:
    return axis_size(mesh, "model")
