"""Production mesh builders. Port of ``repro/launch/mesh.py``.

Functions, not module-level constants: importing this module never
touches a process group. Each builder lays its ``DeviceMesh`` over the
current default group (``torch.distributed.init_process_group``), which
the caller opens: the dry-run's ``"fake"`` group of 256 or 512 ranks in
one process (the reference's placeholder devices), or one rank per GPU.
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 = 256 chips/pod (data, model); multi-pod adds the pod axis:
    2 pods = 512 chips (pod, data, model)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1):
    """The ranks of the current group, one GPU a rank: (world // model,
    model) over (data, model)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh: no CUDA device (one GPU a rank)")
    n = dist.get_world_size()
    return init_device_mesh("cuda", (n // model, model),
                            mesh_dim_names=("data", "model"))


def axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
