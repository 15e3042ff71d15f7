"""Layout helper shared by formats.py and the graph passes (a port of
``repro.core.sparse.packing``'s ``block_mask``)."""

from __future__ import annotations

import torch

__all__ = ["block_mask"]


def block_mask(mask: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """[K, N] elementwise mask -> [Kb, Nb] bool kept-block map."""
    k, n = mask.shape
    return torch.any(mask.reshape(k // bm, bm, n // bn, bn) != 0, dim=3).any(dim=1)
