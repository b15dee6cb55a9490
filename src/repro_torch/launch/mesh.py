"""Production meshes — the reference's ``launch/mesh.py``.

Functions (not module-level constants): a ``DeviceMesh`` needs a default
process group whose world size is the mesh's size (the fake group of the
dry run, gloo on the CPU, NCCL on the card), and importing this module
must not need one (the sharding rules read only the axis names and
sizes, and take any object that has them).
"""
from __future__ import annotations

from typing import Tuple

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def production_layout(multi_pod: bool = False
                      ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Single pod: 16x16 = 256 chips (data, model).
    Multi-pod:  2x16x16 = 512 chips (pod, data, model)."""
    if multi_pod:
        return MULTI_POD_SHAPE, MULTI_POD_AXES
    return PRODUCTION_SHAPE, PRODUCTION_AXES


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh`` over the default process group,
    which must have 256 (512 with ``multi_pod``) ranks; on the card
    unless ``device_type`` says otherwise (the dry run's fake group:
    "cpu")."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = production_layout(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(n_devices: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A small (data, model) ``DeviceMesh`` for tests and one card; the
    default process group must have ``n_devices`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (max(n_devices // model, 1), model),
                            mesh_dim_names=("data", "model"))
