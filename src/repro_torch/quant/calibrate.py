"""Absmax activation calibration over execution plans (a port of
``repro.quant.calibrate``).

The ``quantize`` pass needs one number per graph value to pick activation
scales for W8A8 GEMMs and convs: the largest magnitude that value takes on
representative inputs.  :func:`calibrate_plan` runs sample batches through a
compiled :class:`~repro_torch.core.graph.executor.ExecutionPlan` (the
reference backend is the usual choice) and records per-value absmax ranges
into a :class:`CalibrationTable`, which persists to JSON in the JAX
package's schema (``{"version": 1, "batches": n, "ranges": {...}}``), so a
table saved by either package loads in the other.

Table keys are *graph value names*: the graph's input names plus every node
name.  A node's activation scale is looked up under its **input** name --
the range of what flows *into* the GEMM.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple, Union

import torch

from .qtensor import QMAX

__all__ = ["CalibrationTable", "calibrate_plan"]


@dataclasses.dataclass
class CalibrationTable:
    """Per-value activation ranges: ``{value_name: absmax}`` (Python floats).

    ``observe`` folds a new observation in via running max -- the table is
    monotone over batches, so calibration order never matters.
    """

    ranges: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: number of sample batches folded in (provenance, not used numerically)
    batches: int = 0

    def observe(self, name: str, value: Any) -> None:
        r = float(torch.as_tensor(value).float().abs().max())
        prev = self.ranges.get(name)
        self.ranges[name] = r if prev is None else max(prev, r)

    def __contains__(self, name: str) -> bool:
        return name in self.ranges

    def scale(self, name: str) -> float:
        """Symmetric int8 activation scale for value ``name``."""
        return max(self.ranges[name], 1e-12) / QMAX

    def get_scale(self, name: str) -> Optional[float]:
        return self.scale(name) if name in self.ranges else None

    # -- persistence --------------------------------------------------------- #
    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(
                {"version": 1, "batches": self.batches, "ranges": self.ranges},
                f,
                indent=2,
                sort_keys=True,
            )
        return path

    @classmethod
    def load(cls, path: str) -> "CalibrationTable":
        with open(path) as f:
            payload = json.load(f)
        return cls(
            ranges={k: float(v) for k, v in payload["ranges"].items()},
            batches=int(payload.get("batches", 0)),
        )


def calibrate_plan(
    plan,
    params: Dict[str, Dict[str, Any]],
    batches: Iterable[Union[torch.Tensor, Tuple[torch.Tensor, ...], Sequence[torch.Tensor]]],
    table: Optional[CalibrationTable] = None,
) -> CalibrationTable:
    """Run ``batches`` through ``plan`` recording per-value absmax ranges.

    Each batch is one plan invocation's inputs: a single tensor (or array)
    for single-input graphs, or a tuple/list of them.  An existing
    ``table`` may be passed to fold more batches into a previous
    calibration.
    """
    table = table or CalibrationTable()
    with torch.no_grad():
        for xs in batches:
            if not isinstance(xs, (tuple, list)):
                xs = (xs,)
            plan.run_steps(params, *xs, observer=table.observe)
            table.batches += 1
    return table
