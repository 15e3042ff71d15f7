"""Compact sparse weight storage (paper section 3, "Sparse model storage").

A port of ``repro.core.sparse.formats``.  The three formats the compiler
produces pack torch tensors on the tensors' device, so a bf16 weight on the
card packs there; the storage baseline ``CSR`` is host-side numpy, as in
the JAX package.

``PBCSR``
    Packed Block Compressed Sparse (column-major) storage for block pruning:
    one int32 per surviving ``(bm, bn)`` block.  Stored output-column-major
    (``values[Nb, S, bm, bn]``, ``block_rows[Nb, S]``, -1 = pad) so the
    block-sparse kernel walks one output block-column's blocks in order;
    the per-column counts are equalized by the balanced projection or by
    the reorder pass (bands).

``ColumnCompact``
    For column pruning along K: the kept rows of ``W[K, N]`` are physically
    compacted to a dense ``[K_kept, N]`` plus one int32 per kept row.
    Runtime = static input gather + strictly smaller dense GEMM.

``ChannelCompact``
    For channel pruning along N: dense ``[K, N_kept]`` + kept-column
    indices; the graph pass folds the index map into the *next* layer, so
    runtime cost is zero.

``CSR``
    The textbook baseline the paper compares against (storage only): one
    int32 column index per surviving weight.

All round-trip exactly through ``to_dense`` and report ``nbytes``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .packing import block_mask

__all__ = ["PBCSR", "ColumnCompact", "ChannelCompact", "CSR", "dense_nbytes"]


def dense_nbytes(shape: Tuple[int, ...], dtype=torch.bfloat16) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * torch.empty((), dtype=dtype).element_size()


def _kept_index(live: torch.Tensor) -> torch.Tensor:
    idx = torch.nonzero(live).flatten()
    if idx.numel() == 0:
        idx = torch.zeros(1, dtype=torch.int64, device=live.device)
    return idx.to(torch.int32)


@dataclasses.dataclass
class PBCSR:
    """Packed block storage, output-column-major, padded to uniform count.

    ``values[j, s]`` is the s-th surviving (bm, bn) block of output
    block-column j; ``block_rows[j, s]`` its block-row index in the dense
    weight (-1 marks padding; padded values are zero, so accumulating them
    is exact, merely wasted work -- the reorder pass exists to minimize it).
    Kept rows are stored in ascending order, pads last.
    """

    values: torch.Tensor  # [Nb, S, bm, bn]
    block_rows: torch.Tensor  # [Nb, S] int32, -1 = pad
    shape: Tuple[int, int]
    bm: int = 128
    bn: int = 128

    @classmethod
    def from_dense(
        cls, w: torch.Tensor, mask: torch.Tensor, bm: int = 128, bn: int = 128
    ) -> "PBCSR":
        k, n = w.shape
        if k % bm or n % bn:
            raise ValueError(f"blocks ({bm},{bn}) do not tile {tuple(w.shape)}")
        w = w * mask.to(w.dtype)
        kb, nb = k // bm, n // bn
        bmask = block_mask(mask, bm, bn)  # [Kb, Nb]
        counts = bmask.sum(dim=0)  # per output block-column
        s_max = max(int(counts.max()) if nb else 0, 1)
        # per column: kept block-rows first, ascending (a stable sort of the
        # "pruned" flags), then the pruned ones, cut to s_max
        order = torch.argsort((~bmask).t().to(torch.int8), dim=1, stable=True)
        rows = order[:, :s_max]
        valid = torch.arange(s_max, device=w.device)[None, :] < counts[:, None]
        blocks = w.reshape(kb, bm, nb, bn).permute(2, 0, 1, 3)  # [Nb, Kb, bm, bn]
        picked = blocks[torch.arange(nb, device=w.device)[:, None], rows]  # [Nb, S, bm, bn]
        values = torch.where(valid[..., None, None], picked, torch.zeros((), dtype=w.dtype,
                                                                         device=w.device))
        block_rows = torch.where(valid, rows, torch.full_like(rows, -1)).to(torch.int32)
        return cls(values=values.contiguous(), block_rows=block_rows.contiguous(),
                   shape=(k, n), bm=bm, bn=bn)

    def to_dense(self) -> torch.Tensor:
        k, n = self.shape
        kb, nb = k // self.bm, n // self.bn
        out = self.values.new_zeros((kb, nb, self.bm, self.bn))
        j, s = torch.nonzero(self.block_rows >= 0, as_tuple=True)
        out[self.block_rows[j, s].long(), j] = self.values[j, s]
        return out.permute(0, 2, 1, 3).reshape(k, n)

    @property
    def n_blocks(self) -> int:
        return int((self.block_rows >= 0).sum())

    @property
    def padded_blocks(self) -> int:
        return self.block_rows.numel() - self.n_blocks

    @property
    def nbytes(self) -> int:
        """True storage cost: surviving blocks + one int32 each (padding is an
        execution artefact, not a storage one -- serialized form stores
        ragged)."""
        return self.n_blocks * (self.bm * self.bn * self.values.element_size() + 4)

    @property
    def nbytes_padded(self) -> int:
        return self.values.numel() * self.values.element_size() + self.block_rows.numel() * 4


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


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class CSR:
    """Textbook CSR -- storage-size baseline only (host-side, numpy; a torch
    tensor is read through ``.cpu().numpy()``, so it needs a numpy dtype)."""

    data: np.ndarray
    indices: np.ndarray  # int32 column index per nonzero  <- the redundancy
    indptr: np.ndarray  # [K+1] int64
    shape: Tuple[int, int]

    @classmethod
    def from_dense(cls, w, mask) -> "CSR":
        w = _host(w)
        w = w * _host(mask).astype(w.dtype)
        k, n = w.shape
        indptr = np.zeros(k + 1, np.int64)
        idx, data = [], []
        for i in range(k):
            nz = np.nonzero(w[i])[0]
            idx.append(nz.astype(np.int32))
            data.append(w[i, nz])
            indptr[i + 1] = indptr[i] + len(nz)
        return cls(
            data=np.concatenate(data) if data else np.zeros(0, w.dtype),
            indices=np.concatenate(idx) if idx else np.zeros(0, np.int32),
            indptr=indptr,
            shape=(k, n),
        )

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, self.data.dtype)
        for i in range(self.shape[0]):
            lo, hi = self.indptr[i], self.indptr[i + 1]
            out[i, self.indices[lo:hi]] = self.data[lo:hi]
        return out

    @property
    def nbytes(self) -> int:
        return self.data.nbytes + self.indices.nbytes + self.indptr.nbytes
