"""Production mesh definition (the port of ``repro.launch.mesh``; a
function: importing never touches a device or a process group)."""
from __future__ import annotations

__all__ = ["make_production_mesh", "POD_SHAPE", "MULTI_POD_SHAPE"]

POD_SHAPE = (16, 16)              # one pod slice: 256 chips
MULTI_POD_SHAPE = (2, 16, 16)     # 2 pods: 512 chips


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``repro``'s production shape and axis names over
    the process group that is up (its world size must be the mesh's)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = MULTI_POD_SHAPE if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
