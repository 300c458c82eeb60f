"""Production mesh construction: the port of ``repro.launch.mesh``.

A FUNCTION, not a module-level constant: importing this module touches no
process group.  Both return a ``DeviceMesh`` over the current process
group, whose world size must be the mesh's size (one SPMD process a
rank).  ``device_type`` is "cuda" unless the caller asks for "cpu" (a
gloo group on the host, or the dry run's fake group).
"""
from __future__ import annotations


def _mesh(shape, names, device_type):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0,
                    device_type: str = "cuda"):
    """Small mesh for tests and the chip check (world size permitting)."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"),
                     device_type)
    return _mesh((data, model), ("data", "model"), device_type)
