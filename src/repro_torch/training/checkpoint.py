"""Checkpointing: atomic, keep-N, step-resumable (a port of
``repro.training.checkpoint``, in the JAX package's layout).

Layout (one directory per step)::

    <dir>/step_000000123/
        arrays.npz        # every leaf, key = sanitized keystr path
        meta.json         # step, keys, shapes/dtypes, user metadata

Writes go to ``step_XXXX.tmp`` then ``os.replace`` (atomic on POSIX), so a
preemption mid-save never corrupts the latest checkpoint.  Restore takes a
*template* tree and returns its structure with the saved values: a tensor
leaf comes back on the template tensor's device in its dtype, a Python int
or float leaf (the port's host-side step counts and ``rho``) as an int or
float.  Keys are the sanitized ``keystr`` paths of ``utils.tree``, so the
JAX package's checkpoints of the same tree restore here.

numpy has no bf16: a bf16 tensor is stored by its 16-bit patterns (uint16)
with ``"bfloat16"`` in ``meta.json``'s ``dtypes``; a bf16 array the JAX
package stored (an ``ml_dtypes`` array, read back as 2-byte void) is read by
its bits the same way.

Mesh-elastic: ``save`` gathers a DTensor leaf to its full array (every rank
of its mesh calls ``save``; rank 0 writes, the others wait for it), and
``restore(..., placements=)`` places each leaf by a tree of
``models.sharding.NamedSharding`` -- pass those of a *different* mesh to
re-scale, the JAX package's ``shardings=``.  A DTensor template leaf with
no placement given is placed as the template.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.sharding import is_dtensor
from ..utils.tree import leaves, leaves_with_path, map_with_path

__all__ = ["save", "restore", "latest_step", "all_steps", "CheckpointManager"]

Tree = Any


def _sanitize(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.]+", "_", path).strip("_")


def _flatten(tree: Tree) -> List[Tuple[str, Any]]:
    out = []
    seen: Dict[str, int] = {}
    for path, leaf in leaves_with_path(tree):
        key = _sanitize(path)
        if key in seen:  # disambiguate collisions deterministically
            seen[key] += 1
            key = f"{key}__{seen[key]}"
        else:
            seen[key] = 0
        out.append((key, leaf))
    return out


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """``(array, dtype name)`` of a leaf; bf16 as its bits."""
    if isinstance(leaf, torch.Tensor):
        t = (leaf.full_tensor() if is_dtensor(leaf) else leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(
    directory: str,
    step: int,
    tree: Tree,
    *,
    extra_meta: Optional[Dict[str, Any]] = None,
) -> str:
    """Atomic full-tree save.  Returns the final checkpoint path.  With
    DTensor leaves every rank of their mesh calls it (the gathers are
    collectives) and rank 0 of the default group writes."""
    final = os.path.join(directory, f"step_{step:09d}")
    flat = _flatten(tree)
    arrays, dtypes = {}, {}
    for k, v in flat:
        arrays[k], dtypes[k] = _to_numpy(v)
    meshed = any(is_dtensor(v) for _, v in flat)
    if meshed and dist.get_rank() != 0:
        dist.barrier()  # rank 0 is writing
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {
        "step": step,
        "keys": [k for k, _ in flat],
        "shapes": {k: list(np.shape(a)) for k, a in arrays.items()},
        "dtypes": dtypes,
        **(extra_meta or {}),
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    if meshed:
        dist.barrier()
    return final


def _from_numpy(arr: np.ndarray, dtype_name: Optional[str], tmpl, sharding=None):
    if not isinstance(tmpl, torch.Tensor):
        if isinstance(tmpl, bool):
            return bool(arr)
        if isinstance(tmpl, int):
            return int(arr)
        if isinstance(tmpl, float):
            return float(arr)
        return np.asarray(arr, dtype=getattr(tmpl, "dtype", None))
    if dtype_name == "bfloat16" or arr.dtype.kind == "V":  # bf16 by its bits
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if sharding is None and is_dtensor(tmpl):
        mesh, placements = tmpl.device_mesh, tmpl.placements
    elif sharding is not None:
        mesh, placements = sharding.mesh, sharding.placements
    else:
        return t.to(device=tmpl.device, dtype=tmpl.dtype)
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.to(device=mesh.device_type, dtype=tmpl.dtype), mesh, placements)


def restore(
    directory: str,
    template: Tree,
    *,
    step: Optional[int] = None,
    placements: Optional[Tree] = None,
) -> Tuple[Tree, int]:
    """Restore into the structure of ``template``; returns (tree, step).

    ``placements`` (a tree of ``NamedSharding`` mirroring ``template``)
    distributes each leaf on its mesh: those of another mesh than the saved
    one re-scale elastically."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    with open(os.path.join(path, "meta.json")) as f:
        dtypes = json.load(f).get("dtypes", {})
    flat = _flatten(template)
    keys = [k for k, _ in flat]
    if set(keys) != set(arrays.keys()):
        missing = set(keys) - set(arrays)
        extra = set(arrays) - set(keys)
        raise ValueError(f"checkpoint/template mismatch: missing={missing} extra={extra}")
    shardings = leaves(placements) if placements is not None else [None] * len(flat)
    if len(shardings) != len(flat):
        raise ValueError(f"{len(shardings)} placements for {len(flat)} leaves")
    out = []
    for (k, tmpl), sh in zip(flat, shardings):
        arr = arrays[k]
        if tuple(arr.shape) != tuple(np.shape(tmpl)):
            raise ValueError(f"{k}: saved {arr.shape} vs template {tuple(np.shape(tmpl))}")
        out.append(_from_numpy(arr, dtypes.get(k), tmpl, sh))
    it = iter(out)
    return map_with_path(lambda *_: next(it), template), step


def all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


class CheckpointManager:
    """save-every-K + keep-N retention + resume, with a save hook for the
    preemption handler (fault_tolerance.PreemptionHandler)."""

    def __init__(self, directory: str, *, save_every: int = 100, keep: int = 3):
        self.directory = directory
        self.save_every = save_every
        self.keep = keep

    def maybe_save(self, step: int, tree: Tree, *, force: bool = False, **meta) -> Optional[str]:
        if not force and (step % self.save_every) != 0:
            return None
        path = save(self.directory, step, tree, extra_meta=meta)
        self._gc()
        return path

    def restore_latest(self, template: Tree, *, placements: Optional[Tree] = None
                       ) -> Optional[Tuple[Tree, int]]:
        if latest_step(self.directory) is None:
            return None
        return restore(self.directory, template, placements=placements)

    def _gc(self) -> None:
        steps = all_steps(self.directory)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"), ignore_errors=True)
