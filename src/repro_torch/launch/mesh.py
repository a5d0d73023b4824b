"""Production and debug meshes, the port of ``repro/launch/mesh.py``.

Each is a FUNCTION that builds a ``DeviceMesh`` with named dims over the
default process group (never a module-level constant: importing this
module touches no process group). The caller opens the group first
(``torch.distributed.init_process_group``, with its address, world size
and rank given); a group of another size than the mesh's raises. The
mesh's device type follows the tensors: ``"cuda"`` unless the caller asks
for ``"cpu"``.
"""

from __future__ import annotations

import math


def _mesh(shape: tuple[int, ...], names: tuple[str, ...], device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of {need} ranks; none is "
                           f"initialized")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"a {shape} mesh needs {need} ranks; the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Single-pod 16x16 (256 ranks) or 2-pod 2x16x16 (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def dp_axes(multi_pod: bool = False) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, *, device_type: str = "cuda"):
    """Small ``(n_data, n_model)`` mesh (8 ranks by default) for tests and
    the launcher's ``--mesh debug``."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)
