"""Per-layer sparsity scheduling + one-shot sensitivity analysis (a port of
``repro.core.pruning.schedule``).

The paper assigns per-layer sparsities by hand ("column pruning for style
transfer, kernel pruning for coloring/SR").  At framework scale the
assignment is automated: a quick *sensitivity scan* (one-shot prune each
layer at a few candidate sparsities, measure the loss delta on a probe
batch) followed by a greedy global assignment that hits a target overall
compression at minimum summed sensitivity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Sequence, Union

import torch

from ...utils.tree import leaves_with_path, map_with_path
from .projections import project
from .structures import Structure

__all__ = ["SensitivityResult", "sensitivity_scan", "assign_sparsities", "polynomial_schedule"]

Tree = Any


@dataclasses.dataclass
class SensitivityResult:
    #: {path: {sparsity: loss_delta}}
    table: Dict[str, Dict[float, float]]
    base_loss: float


def _set_leaf(params: Tree, target: str, value) -> Tree:
    return map_with_path(lambda path, w: value if path == target else w, params)


@torch.no_grad()
def sensitivity_scan(
    loss_fn: Callable[[Tree], torch.Tensor],
    params: Tree,
    candidates: Dict[str, Structure],
    sparsities: Sequence[float] = (0.3, 0.5, 0.7, 0.9),
) -> SensitivityResult:
    """One-shot prune each candidate leaf at each sparsity; record loss delta.

    ``loss_fn`` should close over a fixed probe batch (deterministic).
    """
    base = float(loss_fn(params))
    table: Dict[str, Dict[float, float]] = {}
    flat = dict(leaves_with_path(params))
    for path, st in candidates.items():
        w = flat[path]
        row: Dict[float, float] = {}
        for sp in sparsities:
            st_sp = dataclasses.replace(st, sparsity=sp)
            try:
                st_sp.validate(tuple(w.shape))
            except ValueError:
                continue
            wp, _ = project(w, st_sp)
            loss = float(loss_fn(_set_leaf(params, path, wp.to(w.dtype))))
            row[sp] = loss - base
        table[path] = row
    return SensitivityResult(table=table, base_loss=base)


def assign_sparsities(
    sens: SensitivityResult,
    sizes: Dict[str, int],
    target_compression: float,
    sparsities: Sequence[float] = (0.3, 0.5, 0.7, 0.9),
) -> Dict[str, float]:
    """Greedy: repeatedly bump the layer whose next sparsity level costs the
    least loss-delta per pruned weight, until the global pruned fraction over
    candidate layers reaches ``target_compression``."""
    levels = sorted(sparsities)
    cur: Dict[str, int] = {p: -1 for p in sens.table}  # index into levels, -1 = dense
    total = sum(sizes[p] for p in sens.table)
    if total == 0:
        return {}

    def pruned_now() -> float:
        return (
            sum(sizes[p] * (levels[i] if i >= 0 else 0.0) for p, i in cur.items())
            / total
        )

    while pruned_now() < target_compression:
        best_path, best_cost = None, float("inf")
        for p, i in cur.items():
            if i + 1 >= len(levels) or levels[i + 1] not in sens.table[p]:
                continue
            nxt = levels[i + 1]
            prev_delta = sens.table[p].get(levels[i], 0.0) if i >= 0 else 0.0
            gain_weights = sizes[p] * (nxt - (levels[i] if i >= 0 else 0.0))
            cost = (sens.table[p][nxt] - prev_delta) / max(gain_weights, 1)
            if cost < best_cost:
                best_cost, best_path = cost, p
        if best_path is None:
            break  # nothing left to bump
        cur[best_path] += 1
    return {p: (levels[i] if i >= 0 else 0.0) for p, i in cur.items()}


def polynomial_schedule(
    step: Union[int, torch.Tensor], begin: int, end: int, final_sparsity: float,
    power: float = 3.0,
) -> torch.Tensor:
    """Zhu&Gupta-style gradual sparsity ramp for mask-updating baselines
    (f32, as the JAX package computes it)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    t = torch.clamp((step - begin) / max(end - begin, 1), 0.0, 1.0)
    return final_sparsity * (1.0 - (1.0 - t) ** power)
