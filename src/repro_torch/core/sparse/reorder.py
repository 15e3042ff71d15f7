"""Matrix reorder (paper section 3, "Matrix reorder"): a port of
``repro.core.sparse.reorder``.

The block-sparse kernel is output-stationary: one output tile per (M-tile,
output block-column), walking that column's packed blocks.  The imbalance
analogue of the paper's SpMM thread imbalance is *per-output-column
surviving-block counts* differing -- every column pads to the max count and
the padding is wasted work.  The reorder therefore:

1. sorts output block-columns by surviving count;
2. partitions them into *bands* of equal (or near-equal) count, so the ops
   layer issues one kernel launch per band with an exact trip count;
3. emits a column permutation which the graph layer records as a foldable
   ``gather_channels`` glue node (permuting a layer's output features =
   permuting the next weight's input rows).

The planning (sort + the dynamic program over split points) is numpy, as in
the JAX package; the permutes act on torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "ReorderPlan",
    "Band",
    "plan_reorder",
    "balance_stats",
    "apply_column_perm",
    "invert_column_perm",
    "fold_perm_into_next",
]


@dataclasses.dataclass(frozen=True)
class Band:
    """A contiguous (post-permutation) group of output block-columns executed
    with one kernel launch of exactly ``count`` accumulation steps."""

    start: int  # first block-column (in permuted order)
    stop: int  # one past last
    count: int  # surviving blocks per column in this band (max over members)

    @property
    def n_cols(self) -> int:
        return self.stop - self.start


@dataclasses.dataclass(frozen=True)
class ReorderPlan:
    """Column permutation + band partition for one pruned weight."""

    #: ``order[new_pos] = old_j`` (argsort form, easiest to apply)
    order: np.ndarray  # [Nb] int32
    bands: Tuple[Band, ...]
    bm: int
    bn: int
    #: waste fraction before/after (padded blocks / real blocks)
    waste_before: float
    waste_after: float

    @property
    def identity(self) -> bool:
        return bool(np.all(self.order == np.arange(len(self.order))))


def _counts(bmask: np.ndarray) -> np.ndarray:
    return bmask.sum(axis=0).astype(np.int64)  # per output block-column


def balance_stats(bmask: np.ndarray) -> dict:
    """Imbalance metrics of a [Kb, Nb] block-kept map (output-column view)."""
    c = _counts(np.asarray(bmask))
    mx = int(c.max(initial=0))
    total = int(c.sum())
    padded = int((mx - c).sum())
    return {
        "max": mx,
        "mean": float(c.mean()) if len(c) else 0.0,
        "min": int(c.min(initial=0)),
        "waste_frac": padded / max(total, 1),
        "imbalance": (mx / max(float(c.mean()), 1e-9)) if len(c) else 1.0,
    }


def plan_reorder(
    bmask: np.ndarray, max_bands: int = 4, bm: int = 128, bn: int = 128
) -> ReorderPlan:
    """Sort output block-columns by surviving count and cut into <=max_bands
    bands minimizing total padding (dynamic programming over split points)."""
    bmask = np.asarray(bmask, bool)
    _, nb = bmask.shape
    c = _counts(bmask)
    order = np.argsort(c, kind="stable").astype(np.int32)  # ascending count
    sorted_c = c[order]
    before = balance_stats(bmask)

    # cost of a band = its padding: each band pads to its own max (= its
    # last element, counts sorted ascending)
    inf = float("inf")
    cum = np.concatenate([[0], np.cumsum(sorted_c)])

    def band_cost(i: int, j: int) -> float:  # columns i..j-1 in one band
        return float(sorted_c[j - 1] * (j - i) - (cum[j] - cum[i]))

    n = nb
    dp = np.full((max_bands + 1, n + 1), inf)
    choice = np.zeros((max_bands + 1, n + 1), np.int32)
    dp[0, 0] = 0.0
    for b in range(1, max_bands + 1):
        for j in range(1, n + 1):
            for i in range(j):
                if dp[b - 1, i] == inf:
                    continue
                cost = dp[b - 1, i] + band_cost(i, j)
                if cost < dp[b, j]:
                    dp[b, j] = cost
                    choice[b, j] = i
    best_b = int(np.argmin(dp[:, n]))  # the fewest bands among the cheapest
    cuts = []
    j = n
    for b in range(best_b, 0, -1):
        i = int(choice[b, j])
        cuts.append((i, j))
        j = i
    cuts.reverse()
    bands = tuple(
        Band(start=i, stop=j, count=int(sorted_c[j - 1]) if j > i else 0)
        for i, j in cuts
        if j > i
    )
    total = int(sorted_c.sum())
    padded_after = sum(b.count * b.n_cols for b in bands) - total
    return ReorderPlan(
        order=order,
        bands=bands,
        bm=bm,
        bn=bn,
        waste_before=before["waste_frac"],
        waste_after=padded_after / max(total, 1),
    )


def _index(order: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(order, np.int64), device=device)


def apply_column_perm(w: torch.Tensor, order: np.ndarray, bn: int) -> torch.Tensor:
    """Permute output block-columns of ``W[K, N]`` per ``order`` (gather)."""
    k, n = w.shape
    return w.reshape(k, n // bn, bn).index_select(1, _index(order, w.device)).reshape(k, n)


def invert_column_perm(order: np.ndarray) -> np.ndarray:
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order), dtype=order.dtype)
    return inv


def fold_perm_into_next(w_next: torch.Tensor, order: np.ndarray, bn: int) -> torch.Tensor:
    """Fold an output-column permutation of layer L into layer L+1's input
    rows: ``W_next[K, N]`` with K = bn * Nb_prev has its input-row blocks
    gathered by the same order."""
    k, n = w_next.shape
    return w_next.reshape(k // bn, bn, n).index_select(0, _index(order, w_next.device)).reshape(k, n)
