"""The device type of the ``DeviceMesh``es that the modules of ``parallel``
build over the default process group (horizon, batch and multihost)."""
import torch.distributed as dist

__all__ = ["mesh_device_type"]


def mesh_device_type() -> str:
    """The device type of the meshes the default process group serves:
    "cuda" under NCCL, "cpu" under gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"
