"""Layout helpers shared by formats.py, reorder.py and the graph passes (a
port of ``repro.core.sparse.packing``).

They take torch tensors and return tensors on the weight's device, in its
dtype, with int32 block rows.  ``pack_balanced`` / ``unpack_balanced`` run
once at compile time, as in the JAX package, through ``PBCSR``'s packing.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "block_mask",
    "pad_to_multiple",
    "extract_blocks",
    "pack_balanced",
    "unpack_balanced",
]


def block_mask(mask: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """[K, N] elementwise mask -> [Kb, Nb] bool kept-block map."""
    k, n = mask.shape
    return torch.any(mask.reshape(k // bm, bm, n // bn, bn) != 0, dim=3).any(dim=1)


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int) -> torch.Tensor:
    """``x`` zero-padded at the end of ``axis`` to a multiple of ``multiple``."""
    axis = axis % x.dim()
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]  # F.pad counts from the last axis
    return F.pad(x, widths)


def extract_blocks(w: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """[K, N] -> [Kb, Nb, bm, bn]."""
    k, n = w.shape
    return w.reshape(k // bm, bm, n // bn, bn).permute(0, 2, 1, 3)


def pack_balanced(
    w: torch.Tensor, bmask, bm: int, bn: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Column-major packing padded to the max per-column count: the payload
    of ``PBCSR.from_dense`` with every element of a kept block kept.

    ``bmask`` is the [Kb, Nb] kept-block map (numpy or a tensor).  Returns
    ``(values [Nb, S, bm, bn], block_rows [Nb, S] int32 with -1 pad)``;
    ``S`` is at least 1, also when no column keeps a block.  Runs once at
    deployment / compile time, not in the step."""
    from .formats import PBCSR

    bmask = torch.as_tensor(bmask, device=w.device).bool()
    mask = bmask.repeat_interleave(bm, dim=0).repeat_interleave(bn, dim=1)
    fmt = PBCSR.from_dense(w.detach(), mask, bm, bn)
    return fmt.values, fmt.block_rows


def unpack_balanced(
    values: torch.Tensor, rows: torch.Tensor, shape: Tuple[int, int], bm: int, bn: int
) -> torch.Tensor:
    """Inverse of pack_balanced (exact, ignoring -1 pads), on ``values``'
    device and in its dtype."""
    from .formats import PBCSR

    return PBCSR(values=values, block_rows=rows, shape=tuple(shape), bm=bm, bn=bn).to_dense()
