"""Mesh construction, ported from ``repro/launch/mesh.py``: ``DeviceMesh``es
over the processes of the default ``torch.distributed`` group.

Functions, never module-level meshes, so importing this module touches no
process group: the dry run starts its fake group of 256 or 512 ranks first.
"""
from __future__ import annotations


def production_mesh_shape(*, multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """16 x 16 = 256 devices per pod; 2 pods = 512 devices when ``multi_pod``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's production mesh over a group of 256 (512) ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda"):
    """``(world, 1)`` as ``("data", "model")`` over the processes of the
    initialised default group, one device each."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process group (launch.fleet.initialize)")
    return init_device_mesh(device_type, (dist.get_world_size(), 1), mesh_dim_names=("data", "model"))
