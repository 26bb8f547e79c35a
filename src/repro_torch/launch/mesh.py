"""Production meshes: the twin of the JAX package's ``repro/launch/mesh.py``.

Defined as FUNCTIONS over an initialised ``torch.distributed`` world, so
importing this module touches no process group. A mesh is a
``DeviceMesh`` whose dims carry the JAX mesh's axis names; each dim's
process group is ``mesh.get_group(name)``. Its ``device_type`` (``"cuda"``
unless the caller asks for ``"cpu"``) is where the DTensors of the sharded
step live (``sharding/rules.py``); the SPMD pipeline's own collectives
(``pipeline/collectives.py``) take their tensors' device from the tensors
and only use the mesh's groups.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Single pod: 16x16 = 256 ranks ("data", "model").
    Multi-pod: 2x16x16 = 512 ranks ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 2, model: int = 4, device_type: str = "cuda"):
    """Small mesh for CPU tests and one-card runs (the world must hold at
    least data x model ranks)."""
    n = dist.get_world_size()
    assert data * model <= n, (data, model, n)
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
