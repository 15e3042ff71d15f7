"""Mask algebra + sparsity accounting over trees of weights (a port of
``repro.core.pruning.masks``).

A *mask tree* mirrors a params tree, with a 0/1 tensor for every pruned leaf
and ``None`` for untouched leaves.  Every function is pure; masked training
is "multiply weights by mask inside the step" (gradients flow only to
survivors because the mask is constant).  Leaf names are the JAX package's
``keystr`` paths (``utils.tree``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ...utils.tree import leaves, map_with_path, tree_map

__all__ = [
    "apply_masks",
    "mask_gradients",
    "sparsity",
    "tree_sparsity_report",
    "combine_masks",
    "count_params",
]

Tree = Any


def apply_masks(params: Tree, masks: Tree) -> Tree:
    """Elementwise ``w * m`` wherever the mask tree has a mask, identity else."""
    return tree_map(lambda w, m: w if m is None else w * m.to(w.dtype), params, masks)


def mask_gradients(grads: Tree, masks: Tree) -> Tree:
    """Zero gradients of pruned weights (masked-retraining step rule)."""
    return apply_masks(grads, masks)


def sparsity(mask: torch.Tensor) -> float:
    """Fraction of zeros in a single mask."""
    return float(1.0 - torch.mean(mask.float()))


def count_params(params: Tree) -> int:
    return int(sum(x.numel() for x in leaves(params)))


def combine_masks(a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Intersection of two masks (None = all-ones)."""
    if a is None:
        return b
    if b is None:
        return a
    return a * b


def tree_sparsity_report(params: Tree, masks: Tree) -> Dict[str, Any]:
    """Per-leaf and global sparsity accounting.

    Returns ``{"per_leaf": {path: (n_total, n_zero)}, "global": frac,
    "pruned_global": frac_over_masked_leaves, "n_params", "n_zero"}``.  The
    zeros are counted from the masks (the raw params may drift at pruned
    positions during a masked fine-tune); one host sync in all."""
    rows = []  # (path, numel, masked?)
    counts = []

    def visit(path, w, m):
        rows.append((path, w.numel(), m is not None))
        if m is not None:
            counts.append(torch.count_nonzero(m))

    map_with_path(visit, params, masks)
    nonzero = iter(torch.stack(counts).tolist() if counts else [])
    per_leaf: Dict[str, Tuple[int, int]] = {}
    tot = zero = masked_tot = masked_zero = 0
    for path, n, masked in rows:
        z = n - next(nonzero) if masked else 0
        per_leaf[path] = (n, z)
        tot += n
        zero += z
        if masked:
            masked_tot += n
            masked_zero += z
    return {
        "per_leaf": per_leaf,
        "global": zero / max(tot, 1),
        "pruned_global": masked_zero / max(masked_tot, 1),
        "n_params": tot,
        "n_zero": zero,
    }
