"""Lower a Graph (LR DSL) to a callable -- a port of
``repro.core.graph.lowering``, the thin wrapper over the plan compiler.

``use_kernels=True`` selects the kernel-backed handler set, ``False`` the
plain-torch reference handlers.
"""

from __future__ import annotations

from .executor import ExecutionPlan, compile_plan
from .ir import Graph
from ...convert import DeviceLike

__all__ = ["lower"]


def lower(g: Graph, *, use_kernels: bool = True, device: DeviceLike = None) -> ExecutionPlan:
    """Compile ``g`` to a callable ``f(params, *inputs) -> outputs`` (an
    :class:`~.executor.ExecutionPlan`, which also exposes ``.summary()`` and
    ``.memory_estimate(*inputs)``) on ``device`` (``None`` means ``cuda``)."""
    backend = "kernel" if use_kernels else "reference"
    return compile_plan(g, backend=backend, device=device)
