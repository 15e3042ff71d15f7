"""Compact sparse weight storage (paper section 3, "Sparse model storage").

A port of ``repro.core.sparse.formats`` for the two formats the slice's
recipes produce; PBCSR (block pruning) comes with the block-sparse slice.

``ColumnCompact``
    For column pruning along K: the kept rows of ``W[K, N]`` are physically
    compacted to a dense ``[K_kept, N]`` plus one int32 per kept row.
    Runtime = static input gather + strictly smaller dense GEMM.

``ChannelCompact``
    For channel pruning along N: dense ``[K, N_kept]`` + kept-column
    indices; the graph pass folds the index map into the *next* layer, so
    runtime cost is zero.

Both round-trip exactly through ``to_dense`` and report ``nbytes``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["ColumnCompact", "ChannelCompact"]


def _kept_index(live: torch.Tensor) -> torch.Tensor:
    idx = torch.nonzero(live).flatten()
    if idx.numel() == 0:
        idx = torch.zeros(1, dtype=torch.int64, device=live.device)
    return idx.to(torch.int32)


@dataclasses.dataclass
class ColumnCompact:
    """Column pruning along K: dense [K_kept, N] + kept-row indices."""

    values: torch.Tensor  # [K_kept, N]
    kept: torch.Tensor  # [K_kept] int32 (sorted)
    shape: Tuple[int, int]

    @classmethod
    def from_dense(cls, w: torch.Tensor, mask: torch.Tensor) -> "ColumnCompact":
        kept = _kept_index(torch.any(mask != 0, dim=1))
        return cls(values=w.index_select(0, kept), kept=kept, shape=tuple(w.shape))

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.values.dtype, device=self.values.device)
        out[self.kept.long()] = self.values
        return out

    @property
    def nbytes(self) -> int:
        return self.values.numel() * self.values.element_size() + self.kept.numel() * 4


@dataclasses.dataclass
class ChannelCompact:
    """Channel pruning along N: dense [K, N_kept] + kept-column indices."""

    values: torch.Tensor  # [K, N_kept]
    kept: torch.Tensor  # [N_kept] int32 (sorted)
    shape: Tuple[int, int]

    @classmethod
    def from_dense(cls, w: torch.Tensor, mask: torch.Tensor) -> "ChannelCompact":
        kept = _kept_index(torch.any(mask != 0, dim=0))
        return cls(values=w.index_select(1, kept), kept=kept, shape=tuple(w.shape))

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.values.dtype, device=self.values.device)
        out[:, self.kept.long()] = self.values
        return out

    @property
    def nbytes(self) -> int:
        return self.values.numel() * self.values.element_size() + self.kept.numel() * 4
