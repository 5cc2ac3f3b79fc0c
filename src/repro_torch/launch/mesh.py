"""Production meshes, the host mesh and the H100's hardware model (port of
``repro/launch/mesh.py``).

The reference builds its production meshes over 256 and 512 placeholder
TPU devices. The port's production meshes are axis-size plans, the mesh's
named dims and their sizes: the launch plans (``launch.specs``), the
dry-run (``launch.dryrun``) and the roofline (``launch.roofline``) read
sizes, never ranks, so no 256-rank group is built. :func:`make_host_mesh`
builds a real ``DeviceMesh`` over the ranks of the process group present
(the launcher's 1 x 1 client mesh is its smallest case).

The hardware constants are an NVIDIA H100 SXM5's data-sheet figures at its
700 W power limit (dense rates, no sparsity); a card set below 700 W runs
slower under load, so a measurement names the card's limit beside it.
"""
from __future__ import annotations

import torch

SINGLE_POD: dict[str, int] = {"data": 16, "model": 16}
MULTI_POD: dict[str, int] = {"pod": 2, "data": 16, "model": 16}

# NVIDIA H100 SXM5 80GB at its 700 W power limit (data sheet), per card
FP32_FLOPS = 66.9e12  # FP32 units: the port's cuBLAS f32 products (TF32 off)
TF32_FLOPS = 494.7e12  # dense TF32 tensor cores
TF32X3_FLOPS = TF32_FLOPS / 3  # K9 and K10's 3xTF32 split: three tf32 products an f32 one
BF16_FLOPS = 989.4e12  # dense BF16 tensor cores
HBM_BW = 3.35e12  # HBM3, B/s
NVLINK_BW = 450e9  # NVLink 4, B/s a direction, within a node's 8 cards
IB_BW = 50e9  # InfiniBand NDR, about B/s a card across nodes
NODE_CARDS = 8  # cards one NVLink domain joins


def make_production_mesh(*, multi_pod: bool = False) -> dict[str, int]:
    """The production mesh's axis sizes: ``{"data": 16, "model": 16}``, or
    ``{"pod": 2, "data": 16, "model": 16}`` across two pods."""
    return dict(MULTI_POD if multi_pod else SINGLE_POD)


def n_devices(axes: dict[str, int]) -> int:
    out = 1
    for size in axes.values():
        out *= size
    return out


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cpu"):
    """A ``DeviceMesh`` with dims ``("data", "model")`` over the ranks of the
    initialised process group, which must hold exactly ``data * model``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = data * model
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"a {data} x {model} host mesh needs a process group of {n} ranks, "
                           f"this process has {have}")
    return init_device_mesh(torch.device(device_type).type, (data, model),
                            mesh_dim_names=("data", "model"))
