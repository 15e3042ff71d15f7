"""Boundary helpers: numpy param trees in, device resolution.

``params_from_numpy`` takes a ``{node_name: {key: array}}`` tree (the shape
of ``Graph.params``; any array type numpy can read, e.g. params built by the
JAX package and passed through ``numpy.asarray``) and returns the same tree
of torch tensors on ``device``.  Floats become f32, int8 payloads (the
quantized weights of ``qlinear`` / ``qconv2d`` nodes) stay int8, and every
other integer array (the ``kept`` index arrays) becomes int32:
``index_select`` and the CUDA kernels take int32 indices, so the port stores
exactly what the reference stores.

``resolve_device`` is the one rule every entry point follows: ``None``
means ``cuda``, and asking for ``cuda`` on a machine without a GPU raises --
nothing quietly runs on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

__all__ = ["params_from_numpy", "resolve_device"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to run "
            "the plain PyTorch versions on the CPU"
        )
    return dev


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32, copy=False)
    elif arr.dtype.kind in "iu" and arr.dtype != np.int8:
        arr = arr.astype(np.int32, copy=False)
    return torch.tensor(arr, device=device)  # a copy: the array may be read-only


def params_from_numpy(
    tree: Mapping[str, Mapping[str, Any]], device: DeviceLike = None
) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{node: {key: array}}`` -> the same tree of tensors on ``device``."""
    dev = resolve_device(device)
    return {
        node: {k: _to_tensor(v, dev) for k, v in p.items()} for node, p in tree.items()
    }
