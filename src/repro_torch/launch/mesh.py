"""Device meshes and the card's roofline constants (a port of
``repro.launch.mesh``).

``make_mesh`` builds a ``torch.distributed`` ``DeviceMesh`` over the process
group the caller has already initialised (NCCL on the card, gloo on the
CPU); ``make_production_mesh`` keeps the JAX package's production shapes and
axis names, ``(16, 16)`` ``("data", "model")`` and ``(2, 16, 16)``
``("pod", "data", "model")``.  Only the dry run builds those, on a fake
process group of their size (``launch/dryrun.py``).

``HW`` holds one NVIDIA H100 SXM 80 GB's published numbers (NVIDIA's data
sheet, dense rates without sparsity, at the card's full 700 W power limit;
``nvidia-smi --query-gpu=name,power.limit`` reports the card's name and its
limit, "NVIDIA H100 80GB HBM3, 700.00 W" on the machines this port was
measured on).  A card set below 700 W runs slower under load than these
denominators assume.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["HW", "make_mesh", "make_production_mesh", "mesh_device_type"]


class HW:
    """H100 SXM 80 GB constants (the roofline's denominators)."""

    PEAK_FLOPS = 989e12  # bf16 dense FLOP/s per GPU (tensor cores)
    HBM_BW = 3.35e12  # HBM3 bytes/s per GPU
    NVLINK_BW = 450e9  # NVLink 4 bytes/s per direction per GPU
    HBM_BYTES = 80 * 10**9  # 80 GB per GPU
    GPUS_PER_NODE = 8  # NVLink domain of one HGX node


def mesh_device_type(device: Optional[str | torch.device] = None) -> str:
    """``"cuda"`` unless the caller asks for the CPU."""
    return "cuda" if device is None else torch.device(device).type


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group (its world size must be the product of ``shape``)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(mesh_device_type(device), tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)
