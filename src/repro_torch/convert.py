"""Boundary helpers: numpy param trees in, device resolution.

``params_from_numpy`` takes a ``{node_name: {key: array}}`` tree (the shape
of ``Graph.params``; any array type numpy can read, e.g. params built by the
JAX package and passed through ``numpy.asarray``) and returns the same tree
of torch tensors on ``device``; ``lm_params_from_numpy`` does the same for
the nested tree ``models.transformer.init_lm`` builds (dicts and lists of
layer dicts, packed pruned layers included: 4-D ``values``, int32
``block_rows`` / ``kept``, and a ``bands`` entry, which stays a tuple of
``(start, stop, count)`` ints).  bf16 arrays stay bf16 -- numpy has no bf16
of its own, so they arrive as the ``bfloat16`` dtype of ``ml_dtypes`` (kind
``'V'``), which is recognised by its name and moved as its 16-bit patterns,
without importing ``ml_dtypes`` -- other floats become f32, int8 payloads
(the quantized weights of ``qlinear`` / ``qconv2d`` nodes) stay int8, and
every other integer array (the ``kept`` index arrays) becomes int32:
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

__all__ = ["params_from_numpy", "lm_params_from_numpy", "resolve_device"]

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
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: carry the bit patterns
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
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


def lm_params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """A nested param tree (dicts, lists and tuples of arrays, e.g. the JAX
    package's ``init_lm`` output) -> the same structure of tensors on
    ``device``, converted as :func:`params_from_numpy` converts."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: tuple(tuple(int(i) for i in b) for b in v) if k == "bands" else conv(v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return _to_tensor(node, dev)

    return conv(tree)
