"""Production meshes: the twin of the JAX package's ``repro/launch/mesh.py``.

Defined as FUNCTIONS over an initialised ``torch.distributed`` world, so
importing this module touches no process group. A mesh is a
``DeviceMesh`` whose dims carry the JAX mesh's axis names; a rank's stage
is its coordinate on "model", and each dim's process group is
``mesh.get_group(name)``. Its device type is the constant ``DEVICE_TYPE``:
the port's collectives take their tensors' device from the tensors, and
their transport from the group's backend.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

DEVICE_TYPE = "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 16x16 = 256 ranks ("data", "model").
    Multi-pod: 2x16x16 = 512 ranks ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(DEVICE_TYPE, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 2, model: int = 4):
    """Small mesh for CPU tests and one-card runs (the world must hold at
    least data x model ranks)."""
    n = dist.get_world_size()
    assert data * model <= n, (data, model, n)
    return init_device_mesh(DEVICE_TYPE, (data, model),
                            mesh_dim_names=("data", "model"))
