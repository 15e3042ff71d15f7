"""PassManager: the compile pipeline as a registry of named passes (a port
of ``repro.core.graph.pass_manager``; same registry, invariants, pipeline and
per-pass stats, so both packages report identical node counts).

The paper's compiler is a *sequence* of graph rewrites (norm folding,
activation fusion, sparse substitution, gather folding, DCE, ...).  The seed
hardcoded that sequence inside ``passes.optimize``; this module turns it into
a subsystem:

* every pass is **registered by name** via :func:`register_pass` and declares
  optional ``pre``/``post`` invariants (callables that raise
  :class:`InvariantViolation`);
* a :class:`PassManager` runs an ordered pipeline, validating the graph
  between stages and recording per-pass :class:`PassStats`;
* passes that consume pruning artifacts declare ``needs_masks`` and are
  skipped automatically when the :class:`PassContext` carries none.

``passes.optimize`` is now a thin wrapper over
``PassManager(DEFAULT_PIPELINE)``; new passes (see ``fuse_elementwise`` and
``cse`` in passes.py) plug in without touching the manager.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from ...obs import trace as _otrace
from .ir import Graph

__all__ = [
    "InvariantViolation",
    "PassContext",
    "PassStats",
    "GraphPass",
    "register_pass",
    "get_pass",
    "available_passes",
    "PassManager",
    "DEFAULT_PIPELINE",
    "graph_valid",
    "no_foldable_batchnorm",
    "no_dead_nodes",
    "params_bound_to_nodes",
]


class InvariantViolation(RuntimeError):
    """A declared pre/post condition of a pass does not hold."""


@dataclasses.dataclass
class PassContext:
    """Everything a pass may consume besides the graph itself."""

    masks: Dict[str, Any] = dataclasses.field(default_factory=dict)
    structures: Dict[str, Any] = dataclasses.field(default_factory=dict)
    max_bands: int = 4
    #: activation-range table for the ``quantize`` pass; None leaves the
    #: pipeline at full precision.  The port's INT8 slice is not written
    #: yet: a pipeline that reaches ``quantize`` with a table raises
    calibration: Optional[Any] = None
    #: node names the ``quantize`` pass leaves at f32 (the standard
    #: keep-the-output-layer-full-precision accuracy practice)
    quant_skip: Tuple[str, ...] = ()
    #: node names whose *activations* stay f32 (weights still quantize to
    #: int8, scheme pinned to w8): the mixed-precision escape hatch for
    #: residual trunks, where static activation quantization noise
    #: accumulates across blocks (see models/cnn.py:APP_ACT_SKIP)
    act_quant_skip: Tuple[str, ...] = ()
    #: per-pass statistics, filled by PassManager.run in pipeline order
    stats: Dict[str, "PassStats"] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class PassStats:
    name: str
    nodes_before: int
    nodes_after: int
    #: structural change (node set / wiring / param keys) -- pure param-value
    #: rewrites (e.g. masked-dense fallbacks) intentionally do not count
    changed: bool


def _structure_fingerprint(g: Graph):
    return (
        tuple((n.name, n.op, n.inputs) for n in g.nodes),
        g.inputs,
        g.outputs,
        tuple(sorted(g.params)),
    )


Invariant = Callable[[Graph, PassContext], None]
PassFn = Callable[[Graph, PassContext], Graph]


@dataclasses.dataclass(frozen=True)
class GraphPass:
    name: str
    fn: PassFn
    pre: Tuple[Invariant, ...] = ()
    post: Tuple[Invariant, ...] = ()
    #: consumes ctx.masks/structures; skipped when the context has no masks
    needs_masks: bool = False
    #: consumes ctx.calibration; skipped when the context carries none
    needs_calibration: bool = False


_PASS_REGISTRY: Dict[str, GraphPass] = {}


def register_pass(
    name: str,
    *,
    pre: Sequence[Invariant] = (),
    post: Sequence[Invariant] = (),
    needs_masks: bool = False,
    needs_calibration: bool = False,
) -> Callable[[PassFn], PassFn]:
    """Decorator: register ``fn(graph, ctx) -> graph`` under ``name``."""

    def deco(fn: PassFn) -> PassFn:
        if name in _PASS_REGISTRY:
            raise ValueError(f"pass {name!r} already registered")
        _PASS_REGISTRY[name] = GraphPass(
            name=name, fn=fn, pre=tuple(pre), post=tuple(post),
            needs_masks=needs_masks, needs_calibration=needs_calibration,
        )
        return fn

    return deco


def get_pass(name: str) -> GraphPass:
    try:
        return _PASS_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown pass {name!r}; registered: {sorted(_PASS_REGISTRY)}"
        ) from None


def available_passes() -> List[str]:
    return sorted(_PASS_REGISTRY)


# --------------------------------------------------------------------------- #
# standard invariants                                                          #
# --------------------------------------------------------------------------- #


def graph_valid(g: Graph, ctx: PassContext) -> None:
    """Structural well-formedness: unique names, topological def-before-use,
    bound outputs (delegates to Graph.validate)."""
    try:
        g.validate()
    except ValueError as e:
        raise InvariantViolation(str(e)) from e


def no_foldable_batchnorm(g: Graph, ctx: PassContext) -> None:
    """Post fold_norm: no inference BatchNorm left sitting on a single-consumer
    conv/linear output (those must have been folded)."""
    for n in g.nodes:
        if n.op != "norm" or n.attrs.get("kind") != "batch":
            continue
        (src_name,) = n.inputs
        try:
            src = g.node(src_name)
        except KeyError:
            continue
        if src.op in ("linear", "conv2d") and len(g.consumers(src_name)) == 1:
            raise InvariantViolation(f"unfolded batchnorm {n.name} after {src_name}")


def no_dead_nodes(g: Graph, ctx: PassContext) -> None:
    """Post dce: every node is reachable from the graph outputs."""
    live = set(g.outputs)
    by_name = {n.name: n for n in g.nodes}
    stack = [n for n in g.outputs if n in by_name]
    while stack:
        n = by_name[stack.pop()]
        for i in n.inputs:
            if i not in live:
                live.add(i)
                if i in by_name:
                    stack.append(i)
    dead = [n.name for n in g.nodes if n.name not in live]
    if dead:
        raise InvariantViolation(f"dead nodes survive dce: {dead}")


def params_bound_to_nodes(g: Graph, ctx: PassContext) -> None:
    """Every params entry belongs to an existing node (passes that delete
    nodes must also drop their params)."""
    names = {n.name for n in g.nodes}
    orphans = [k for k in g.params if k not in names]
    if orphans:
        raise InvariantViolation(f"params for nonexistent nodes: {orphans}")


# --------------------------------------------------------------------------- #
# the manager                                                                  #
# --------------------------------------------------------------------------- #

#: the deployment pipeline (paper's compiler, end to end).  cse runs before
#: fuse_elementwise so duplicate chains collapse once, not twice;
#: fuse_epilogue runs last-but-dce so it sees both surviving single
#: elementwise nodes and fused_elementwise chains, folding them into their
#: GEMM/conv producer's epilogue program.  quantize comes after
#: fuse_epilogue (epilogue attrs must already be attached so qlinear nodes
#: inherit them) and is skipped unless the context carries a calibration
#: table -- full-precision pipelines are untouched.
DEFAULT_PIPELINE: Tuple[str, ...] = (
    "fold_norm",
    "fuse_activation",
    "substitute_sparse",
    "fold_gathers",
    "cse",
    "fuse_elementwise",
    "fuse_epilogue",
    "quantize",
    "dce",
)


class PassManager:
    """Run an ordered pipeline of registered passes with between-stage
    validation.

    ``passes`` may mix registered names and ad-hoc :class:`GraphPass`
    instances (handy in tests).  ``strict=False`` downgrades invariant
    violations from exceptions to recorded stats -- the default is to fail
    loudly: a broken graph mid-pipeline is a compiler bug.
    """

    def __init__(
        self,
        passes: Optional[Sequence[Union[str, GraphPass]]] = None,
        *,
        validate_between: bool = True,
    ):
        names = DEFAULT_PIPELINE if passes is None else passes
        self.passes: List[GraphPass] = [
            p if isinstance(p, GraphPass) else get_pass(p) for p in names
        ]
        self.validate_between = validate_between

    def run(self, g: Graph, ctx: Optional[PassContext] = None) -> Graph:
        ctx = ctx or PassContext()
        for p in self.passes:
            if (p.needs_masks and not ctx.masks) or (
                p.needs_calibration and ctx.calibration is None
            ):
                ctx.stats[p.name] = PassStats(p.name, len(g.nodes), len(g.nodes), False)
                continue
            for inv in p.pre:
                inv(g, ctx)
            before = len(g.nodes)
            fp = _structure_fingerprint(g)
            with _otrace.span(p.name, cat="pass", nodes_before=before) as sp:
                g2 = p.fn(g, ctx)
                if self.validate_between:
                    graph_valid(g2, ctx)
                for inv in p.post:
                    inv(g2, ctx)
                stats = PassStats(
                    p.name,
                    before,
                    len(g2.nodes),
                    changed=g2 is not g and _structure_fingerprint(g2) != fp,
                )
                sp.set("nodes_after", stats.nodes_after)
                sp.set("changed", stats.changed)
            ctx.stats[p.name] = stats
            g = g2
        return g

    __call__ = run

    def summary(self, ctx: PassContext) -> str:
        lines = ["pass                     nodes  ->  nodes"]
        for s in ctx.stats.values():
            mark = "*" if s.changed else " "
            lines.append(f"{s.name:24s} {s.nodes_before:5d}  -> {s.nodes_after:5d} {mark}")
        return "\n".join(lines)
