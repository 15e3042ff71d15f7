"""LR (layer-wise representation) DSL -- the paper's computational-graph IR.

A :class:`Graph` is a topologically-ordered list of :class:`Node`; every node
names its inputs, carries static ``attrs``, and owns parameters in a separate
``params`` dict of torch tensors (the same Graph lowers with different
weights, e.g. dense vs pruned vs packed).  "Essentially this DSL is
equivalent to the computational graph" (paper section 3) -- ours is exactly
that, with passes in passes.py and the execution-plan compiler in
executor.py.  A port of ``repro.core.graph.ir``: same nodes, same attrs.

Supported ops (enough for the paper's three apps + generic MLP stacks):

=================  =====================================================
op                 attrs / params
=================  =====================================================
input              shape, dtype
linear             params w[K,N], b[N]?; attrs activation?, epilogue?
sparse_linear      packed params (format-dependent); attrs format, bands…,
                   epilogue?
conv2d             params w[Co,Ci,kh,kw], b?, kept? (channelcompact: live
                   input-channel indices, Ci already compacted); attrs
                   stride, padding, groups, dilation, format?,
                   activation?, epilogue?
norm               attrs kind in {batch, instance, layer}; params
                   scale, bias (+ mean, var for batch)
activation         attrs fn
add / mul          (binary, elementwise)
concat             attrs axis
pixel_shuffle      attrs factor       (super-resolution upsampling)
upsample           attrs factor       (nearest)
pad_reflect        attrs pad
gather_channels    attrs idx          (compaction glue, foldable)
=================  =====================================================
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Node", "Graph"]


@dataclasses.dataclass
class Node:
    op: str
    name: str
    inputs: Tuple[str, ...] = ()
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "Node":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Graph:
    nodes: List[Node]
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    #: {node_name: {param_name: array}} -- kept outside nodes so the same
    #: graph structure lowers against dense, masked or packed weights.
    params: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------ #
    def node(self, name: str) -> Node:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def consumers(self, name: str) -> List[Node]:
        return [n for n in self.nodes if name in n.inputs]

    def validate(self) -> None:
        seen = set(self.inputs)
        names = set()
        for n in self.nodes:
            if n.name in names:
                raise ValueError(f"duplicate node {n.name}")
            names.add(n.name)
            for i in n.inputs:
                if i not in seen and i not in names:
                    raise ValueError(f"node {n.name} uses undefined input {i!r}")
            seen.add(n.name)
        for o in self.outputs:
            if o not in seen:
                raise ValueError(f"undefined graph output {o!r}")

    def replace_node(self, name: str, new: Node) -> "Graph":
        nodes = [new if n.name == name else n for n in self.nodes]
        return dataclasses.replace(self, nodes=nodes)

    def without(self, names: set) -> "Graph":
        nodes = [n for n in self.nodes if n.name not in names]
        params = {k: v for k, v in self.params.items() if k not in names}
        return dataclasses.replace(self, nodes=nodes, params=params)

    def rewire(self, old: str, new: str) -> "Graph":
        """Point every consumer of ``old`` at ``new`` (and graph outputs)."""
        nodes = [
            n.replace(inputs=tuple(new if i == old else i for i in n.inputs))
            for n in self.nodes
        ]
        outputs = tuple(new if o == old else o for o in self.outputs)
        return dataclasses.replace(self, nodes=nodes, outputs=outputs)

    # ------------------------------------------------------------------ #
    def summary(self) -> str:
        lines = [f"Graph(inputs={self.inputs}, outputs={self.outputs})"]
        for n in self.nodes:
            np_ = self.params.get(n.name, {})
            pstr = ", ".join(f"{k}:{tuple(v.shape)}" for k, v in np_.items())
            lines.append(f"  {n.name:24s} {n.op:14s} <- {n.inputs} {n.attrs} [{pstr}]")
        return "\n".join(lines)


class GraphBuilder:
    """Tiny fluent helper used by models/cnn.py."""

    def __init__(self, input_names: Sequence[str]):
        self._nodes: List[Node] = []
        self._params: Dict[str, Dict[str, Any]] = {}
        self._inputs = tuple(input_names)
        self._n = 0

    def fresh(self, prefix: str) -> str:
        self._n += 1
        return f"{prefix}_{self._n}"

    def add(self, op: str, inputs, name: Optional[str] = None, params=None, **attrs) -> str:
        name = name or self.fresh(op)
        if isinstance(inputs, str):
            inputs = (inputs,)
        self._nodes.append(Node(op=op, name=name, inputs=tuple(inputs), attrs=attrs))
        if params:
            self._params[name] = dict(params)
        return name

    def build(self, outputs) -> Graph:
        if isinstance(outputs, str):
            outputs = (outputs,)
        g = Graph(
            nodes=self._nodes,
            inputs=self._inputs,
            outputs=tuple(outputs),
            params=self._params,
        )
        g.validate()
        return g
