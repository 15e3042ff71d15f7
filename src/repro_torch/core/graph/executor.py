"""Execution plans: op-registry compilation of LR graphs (a port of
``repro.core.graph.executor`` for the slice's ops and backends).

Compilation (:func:`compile_plan`) happens once per graph:

1. **handler resolution** -- every node op is looked up in the op registry
   (:func:`register_op`); unknown ops fail at *compile* time, not mid-run.
   Two handler sets exist: ``kernel`` (the GEMM/conv/fused ops go through
   the hand-written CUDA kernels) and ``reference`` (plain torch, the parity
   oracle).
2. **topological scheduling** -- Kahn's algorithm with graph order as the
   tiebreak.
3. **buffer liveness** -- each step records which intermediates die after it
   (last use); execution drops its reference right away, so PyTorch's
   caching allocator reuses the memory (the JAX plan is a jitted pure
   function; torch runs eagerly).  :meth:`ExecutionPlan.memory_estimate`
   walks the schedule on meta tensors (no FLOP, no device memory).

The device decides the route, not a flag: a plan compiled for ``cpu`` runs
every kernel's plain version; a ``cuda`` plan launches the CUDA kernels
(and raises if one fails).  ``compile_plan(..., device=None)`` means
``cuda`` and raises without a GPU.

Handlers take ``(params_dict, input_tensors, attrs, runtime)`` and return
the node's output tensor::

    @register_op("my_op")
    def _my_op(p, xs, attrs, rt):
        return ...
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...convert import DeviceLike, resolve_device
from ...kernels import ops as kops
from ...kernels import ref as kref
from ...obs import trace as _otrace
from .ir import Graph, Node

__all__ = [
    "BACKENDS",
    "register_op",
    "registered_ops",
    "handlers_for",
    "Runtime",
    "Step",
    "ExecutionPlan",
    "BatchedPlan",
    "compile_plan",
]

_ACT = kref._ACT

#: ``kernel``: CUDA-kernel-backed GEMM/conv/fused ops.  ``reference``: plain
#: torch (the parity oracle).  The JAX package's ``quant`` and ``guarded``
#: backends come with later slices.
BACKENDS = ("kernel", "reference")

#: backend -> op -> handler(params, inputs, attrs, runtime) -> tensor
_HANDLERS: Dict[str, Dict[str, Callable]] = {b: {} for b in BACKENDS}


def handlers_for(backend: str) -> Dict[str, Callable]:
    """The handler table for ``backend``."""
    return dict(_HANDLERS[backend])


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution-time knobs threaded to every handler."""

    backend: str


def register_op(op: str, backends: Sequence[str] = BACKENDS):
    """Decorator: register an op handler for one or more backends."""

    def deco(fn: Callable) -> Callable:
        for b in backends:
            if b not in _HANDLERS:
                raise ValueError(f"unknown backend {b!r}")
            _HANDLERS[b][op] = fn
        return fn

    return deco


def registered_ops(backend: str = "kernel") -> List[str]:
    return sorted(handlers_for(backend))


# --------------------------------------------------------------------------- #
# epilogue programs (attached by the fuse_epilogue pass)                       #
# --------------------------------------------------------------------------- #
#
# A GEMM/conv node may carry an ``epilogue`` attr: a tuple of steps run on its
# output after bias + the fused ``activation`` attr.  Side-operand slots index
# the *node's own inputs*, and layer/instance-norm scale/bias live in the
# node's params under ``{pkey}_scale`` / ``{pkey}_bias``:
#
#   ("activation", fn) | ("add", j) | ("mul", j)
#   ("norm_layer", pkey, eps) | ("norm_instance", pkey, eps)


def _steps_local(steps, xs, p):
    """Resolve graph-form steps into the kernel-local form shared with
    :func:`kref.apply_steps_ref` and the kernels: ``(steps, sides,
    norm_params)`` with renumbered slots."""
    out, sides, norms = [], [], []
    for step in steps:
        kind = step[0]
        if kind == "activation":
            out.append(step)
        elif kind in ("add", "mul"):
            sides.append(xs[step[1]])
            out.append((kind, len(sides) - 1))
        elif kind in ("norm_layer", "norm_instance"):
            pkey, eps = step[1], step[2]
            norms.append((p[f"{pkey}_scale"], p[f"{pkey}_bias"]))
            out.append(("norm" if kind == "norm_layer" else kind, len(norms) - 1, eps))
        else:
            raise NotImplementedError(f"step {kind}")
    return out, sides, norms


def _apply_epilogue(y, epilogue, xs, p):
    """Plain-torch epilogue tail (the same step interpreter the reference
    handlers use, so the two backends share its math)."""
    if not epilogue:
        return y
    steps, sides, norms = _steps_local(epilogue, xs, p)
    return kref.apply_steps_ref(y, steps, sides, norms)


def _kernel_epilogue(epilogue, xs, out_shape):
    """Translate an epilogue into the kernels' in-tile form: ``(steps,
    sides)`` with slots renumbered into ``sides``.  Returns ``(None, None)``
    when the program cannot run in the kernel (norm steps need whole rows or
    planes; broadcast sides are not output-shaped) -- callers then run the
    kernel without it and apply :func:`_apply_epilogue` after."""
    steps, sides = [], []
    for step in epilogue:
        kind = step[0]
        if kind == "activation":
            steps.append(step)
        elif kind in ("add", "mul"):
            s = xs[step[1]]
            if tuple(s.shape) != tuple(out_shape):
                return None, None
            sides.append(s)
            steps.append((kind, len(sides) - 1))
        else:  # norm_layer / norm_instance
            return None, None
    return tuple(steps), tuple(sides)


# --------------------------------------------------------------------------- #
# handlers: GEMM family (kernel vs reference differ)                           #
# --------------------------------------------------------------------------- #


@register_op("linear", backends=("kernel",))
def _linear_kernel(p, xs, a, rt):
    epi = a.get("epilogue") or ()
    out_shape = (*xs[0].shape[:-1], p["w"].shape[1])
    steps, sides = _kernel_epilogue(epi, xs, out_shape)
    if steps is None:  # not in-kernel: run the GEMM, then the plain tail
        y = kops.matmul(xs[0], p["w"], p.get("b"), activation=a.get("activation"))
        return _apply_epilogue(y, epi, xs, p)
    return kops.matmul(
        xs[0], p["w"], p.get("b"), activation=a.get("activation"),
        epilogue=steps, epilogue_sides=sides,
    )


@register_op("linear", backends=("reference",))
def _linear_ref(p, xs, a, rt):
    y = kref.matmul_ref(xs[0], p["w"], p.get("b"), activation=a.get("activation"))
    return _apply_epilogue(y, a.get("epilogue") or (), xs, p)


@register_op("sparse_linear", backends=("kernel",))
def _sparse_linear_kernel(p, xs, a, rt):
    fmt = a["format"]
    if fmt not in ("colcompact", "channelcompact"):
        raise NotImplementedError(f"sparse format {fmt} is not ported yet")
    epi = a.get("epilogue") or ()
    values = p["values"]
    out_shape = (*xs[0].shape[:-1], values.shape[1])
    steps, sides = _kernel_epilogue(epi, xs, out_shape)
    kw = dict(activation=a.get("activation"))
    if steps is not None:
        kw.update(epilogue=steps, epilogue_sides=sides)
    if fmt == "colcompact":
        y = kops.col_matmul(xs[0], values, p["kept"], p.get("b"), **kw)
    else:
        y = kops.matmul(xs[0], values, p.get("b"), **kw)
    return y if steps is not None else _apply_epilogue(y, epi, xs, p)


@register_op("sparse_linear", backends=("reference",))
def _sparse_linear_ref(p, xs, a, rt):
    fmt = a["format"]
    if fmt == "colcompact":
        y = kref.matmul_ref(
            xs[0].index_select(-1, p["kept"]), p["values"], p.get("b"),
            activation=a.get("activation"),
        )
    elif fmt == "channelcompact":
        y = kref.matmul_ref(xs[0], p["values"], p.get("b"), activation=a.get("activation"))
    else:
        raise NotImplementedError(f"sparse format {fmt} is not ported yet")
    return _apply_epilogue(y, a.get("epilogue") or (), xs, p)


def _conv_out_shape(p, xs, a):
    x, w = xs[0], p["w"]
    oh, ow = kops.conv_out_hw(
        x.shape[2], x.shape[3], w.shape[2], w.shape[3],
        a.get("stride", 1), a.get("padding", "SAME"),
    )
    return (x.shape[0], w.shape[0], oh, ow)


@register_op("conv2d", backends=("kernel",))
def _conv2d_kernel(p, xs, a, rt):
    """Implicit-GEMM kernel path: in-kernel epilogue steps (activation / add
    / mul with output-shaped sides) run on the f32 accumulator; norm steps
    and broadcast sides keep the plain tail.  Channel-pruned convs
    (``format="channelcompact"``, ``kept`` param) contract only the live
    input channels.  Configs outside the kernel's matrix (groups, dilation,
    negative pads, empty output) take the plain version inside ``ops``."""
    epi = a.get("epilogue") or ()
    steps, sides = _kernel_epilogue(epi, xs, _conv_out_shape(p, xs, a))
    kw = dict(
        stride=a.get("stride", 1), padding=a.get("padding", "SAME"),
        groups=a.get("groups", 1), dilation=a.get("dilation", 1),
        kept=p.get("kept"), activation=a.get("activation"),
    )
    if steps is not None:
        kw.update(epilogue=steps, epilogue_sides=sides)
    y = kops.conv2d(xs[0], p["w"], p.get("b"), **kw)
    return y if steps is not None else _apply_epilogue(y, epi, xs, p)


@register_op("conv2d", backends=("reference",))
def _conv2d_ref(p, xs, a, rt):
    """Plain conv at f32 (+ the channel gather for pruned convs), epilogue
    as a plain tail."""
    x = xs[0]
    if p.get("kept") is not None:
        x = x.index_select(1, p["kept"])
    y = kref.conv2d_ref(
        x, p["w"], p.get("b"), stride=a.get("stride", 1),
        padding=a.get("padding", "SAME"), groups=a.get("groups", 1),
        dilation=a.get("dilation", 1), activation=a.get("activation"),
    )
    return _apply_epilogue(y, a.get("epilogue") or (), xs, p)


# --------------------------------------------------------------------------- #
# handlers: shared ops (same implementation on both backends)                  #
# --------------------------------------------------------------------------- #


def _chan(v):
    return v[None, :, None, None]


@register_op("norm")
def _norm(p, xs, a, rt):
    kind = a["kind"]
    eps = a.get("eps", 1e-5)
    x = xs[0]
    if kind == "batch":  # inference: stored stats, per-channel (C of NCHW)
        s = p["scale"] / torch.sqrt(p["var"] + eps)
        return (x - _chan(p["mean"])) * _chan(s) + _chan(p["bias"])
    if kind == "instance":  # per (N, C) over spatial
        mu = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, correction=0)
        y = (x - mu) / torch.sqrt(var + eps)
        return y * _chan(p["scale"]) + _chan(p["bias"])
    if kind == "layer":  # over last dim
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, correction=0)
        return (x - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]
    raise NotImplementedError(kind)


@register_op("activation")
def _activation(p, xs, a, rt):
    return _ACT[a["fn"]](xs[0])


@register_op("add")
def _add(p, xs, a, rt):
    return xs[0] + xs[1]


@register_op("mul")
def _mul(p, xs, a, rt):
    return xs[0] * xs[1]


@register_op("fused_elementwise", backends=("reference",))
def _fused_elementwise(p, xs, a, rt):
    """Plain step interpreter: the parity oracle of the kernel (one memory
    round-trip *per step*)."""
    steps, sides, norms = _steps_local(a["steps"], xs, p)
    return kref.apply_steps_ref(xs[0], steps, sides, norms)


@register_op("fused_elementwise", backends=("kernel",))
def _fused_elementwise_kernel(p, xs, a, rt):
    """One kernel pass over the whole step program: one read + one write.
    Routes to the plain interpreter when the kernel cannot express the node
    (broadcast sides, rank < 2, instance norm, non-vector norm params)."""
    x = xs[0]
    if x.dim() < 2 or any(s.shape != x.shape for s in xs[1:]):
        return _fused_elementwise(p, xs, a, rt)
    steps, sides, norms = _steps_local(a["steps"], xs, p)
    if any(st[0] == "norm_instance" for st in steps) or any(
        s.dim() != 1 or s.shape[-1] != x.shape[-1] for pair in norms for s in pair
    ):
        return _fused_elementwise(p, xs, a, rt)
    return kops.fused_elementwise(x, sides, tuple(steps), norms)


@register_op("concat")
def _concat(p, xs, a, rt):
    return torch.cat(xs, dim=a.get("axis", 1))


@register_op("pixel_shuffle")
def _pixel_shuffle(p, xs, a, rt):
    x, r = xs[0], a["factor"]
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


@register_op("upsample")
def _upsample(p, xs, a, rt):
    r = a["factor"]
    return xs[0].repeat_interleave(r, dim=2).repeat_interleave(r, dim=3)


@register_op("pad_reflect")
def _pad_reflect(p, xs, a, rt):
    pd = a["pad"]
    return F.pad(xs[0], (pd, pd, pd, pd), mode="reflect")


@register_op("gather_channels")
def _gather_channels(p, xs, a, rt):
    axis = a.get("axis", -1)
    x = xs[0]
    idx = torch.as_tensor(np.asarray(a["idx"]), device=x.device).long()
    if a["mode"] == "gather":
        return x.index_select(axis, idx)
    # scatter back to width n along axis
    if axis in (-1, x.dim() - 1):
        out = x.new_zeros((*x.shape[:-1], a["n"]))
        out[..., idx] = x
        return out
    if axis == 1:
        out = x.new_zeros((x.shape[0], a["n"], *x.shape[2:]))
        out[:, idx] = x
        return out
    raise NotImplementedError(axis)


@register_op("global_avg_pool")
def _global_avg_pool(p, xs, a, rt):
    return xs[0].mean(dim=(2, 3))


@register_op("broadcast_spatial")
def _broadcast_spatial(p, xs, a, rt):
    # fuse a [N, C] global feature into a [N, C, H, W] map
    g, ref = xs
    return g[:, :, None, None].expand(g.shape[0], g.shape[1], ref.shape[2], ref.shape[3])


# --------------------------------------------------------------------------- #
# plan compilation                                                             #
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class Step:
    node: Node
    #: intermediate buffers whose last use is this step (freed right after)
    frees: Tuple[str, ...] = ()


def _topo_schedule(g: Graph) -> List[Node]:
    """Kahn's algorithm; original node order breaks ties (stable)."""
    defined = set(g.inputs)
    pending = list(g.nodes)
    order: List[Node] = []
    while pending:
        for i, n in enumerate(pending):
            if all(x in defined for x in n.inputs):
                order.append(n)
                defined.add(n.name)
                del pending[i]
                break
        else:
            names = [n.name for n in pending]
            raise ValueError(f"graph has a cycle or undefined inputs: {names}")
    return order


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(eq=False)
class ExecutionPlan:
    """A compiled, topologically scheduled program over registered op
    handlers.  Callable: ``plan(params, *inputs) -> outputs``; inputs are
    moved to the plan's device, params are expected there already."""

    graph: Graph
    steps: Tuple[Step, ...]
    backend: str
    device: torch.device

    def __post_init__(self):
        self._rt = Runtime(backend=self.backend)
        self._handlers = handlers_for(self.backend)

    # -- execution ----------------------------------------------------------- #
    def __call__(self, params: Dict[str, Dict[str, Any]], *args):
        return self.run_steps(params, *args)

    def run_steps(self, params: Dict[str, Dict[str, Any]], *args):
        """Execute the plan: one handler call per step, dead intermediates
        dropped right after their last use."""
        if len(args) != len(self.graph.inputs):
            raise TypeError(
                f"plan expects {len(self.graph.inputs)} inputs "
                f"{self.graph.inputs}, got {len(args)}"
            )
        env: Dict[str, Any] = {
            name: torch.as_tensor(x, device=self.device)
            for name, x in zip(self.graph.inputs, args)
        }
        if _otrace.enabled():  # one branch per run when tracing is off
            return self._run_steps_traced(env, params)
        for step in self.steps:
            n = step.node
            xs = [env[i] for i in n.inputs]
            env[n.name] = self._handlers[n.op](params.get(n.name, {}), xs, n.attrs, self._rt)
            del xs
            for f in step.frees:  # dead intermediate: release our reference
                del env[f]
        outs = tuple(env[o] for o in self.graph.outputs)
        return outs[0] if len(outs) == 1 else outs

    def _run_steps_traced(self, env, params):
        """The traced twin of the ``run_steps`` loop: one ``cat="plan"``
        span around the run, one ``cat="step"`` span per step carrying op /
        backend / output shape."""
        with _otrace.span(
            "plan", cat="plan", backend=self.backend, steps=len(self.steps),
            outputs=list(self.graph.outputs),
        ):
            for step in self.steps:
                n = step.node
                xs = [env[i] for i in n.inputs]
                with _otrace.span(n.name, cat="step", op=n.op, backend=self.backend) as sp:
                    y = self._handlers[n.op](params.get(n.name, {}), xs, n.attrs, self._rt)
                    sp.set("out_shape", list(y.shape))
                del xs
                env[n.name] = y
                for f in step.frees:
                    del env[f]
        outs = tuple(env[o] for o in self.graph.outputs)
        return outs[0] if len(outs) == 1 else outs

    # -- introspection ------------------------------------------------------- #
    def memory_estimate(self, *inputs) -> Dict[str, Any]:
        """Peak-resident activation bytes under this schedule, walked on meta
        tensors (no FLOP spent, no device memory).  ``inputs`` are tensors or
        shapes (f32 assumed).  Params are counted as always-live."""
        metas = [
            torch.empty(x.shape, dtype=x.dtype, device="meta") if isinstance(x, torch.Tensor)
            else torch.empty(tuple(x), dtype=torch.float32, device="meta")
            for x in inputs
        ]
        pmeta = {
            node: {k: v.to("meta") for k, v in p.items()}
            for node, p in self.graph.params.items()
        }
        leaves = [v for p in pmeta.values() for v in p.values()]
        param_bytes = sum(_nbytes(v) for v in leaves)
        param_bytes_by_dtype: Dict[str, int] = {}
        for v in leaves:
            key = str(v.dtype).replace("torch.", "")
            param_bytes_by_dtype[key] = param_bytes_by_dtype.get(key, 0) + _nbytes(v)
        env: Dict[str, Any] = dict(zip(self.graph.inputs, metas))
        # every op has a reference handler: it computes the same shapes and
        # runs on meta tensors
        handlers = _HANDLERS["reference"]
        rt = Runtime(backend="reference")
        peak = live = sum(_nbytes(t) for t in env.values())
        per_step = []
        for step in self.steps:
            n = step.node
            out = handlers[n.op](pmeta.get(n.name, {}), [env[i] for i in n.inputs], n.attrs, rt)
            env[n.name] = out
            live += _nbytes(out)
            peak = max(peak, live)
            for f in step.frees:
                live -= _nbytes(env.pop(f))
            per_step.append((n.name, _nbytes(out), live))
        return {
            "peak_activation_bytes": int(peak),
            "param_bytes": int(param_bytes),
            "param_bytes_by_dtype": param_bytes_by_dtype,
            "peak_total_bytes": int(peak + param_bytes),
            "per_step": per_step,
            "out_shapes": tuple(tuple(env[o].shape) for o in self.graph.outputs),
        }

    def summary(self) -> str:
        lines = [
            f"ExecutionPlan(backend={self.backend}, device={self.device}, "
            f"steps={len(self.steps)}, inputs={self.graph.inputs}, "
            f"outputs={self.graph.outputs})"
        ]
        for s in self.steps:
            fr = f"  frees {s.frees}" if s.frees else ""
            lines.append(f"  {s.node.name:24s} {s.node.op:18s} <- {s.node.inputs}{fr}")
        return "\n".join(lines)

    # -- batched serving ------------------------------------------------------ #
    def batched(self, batch_size: int, *, via_vmap: bool = False) -> "BatchedPlan":
        """Fixed-batch throughput wrapper: pads the caller's leading axis to a
        ``batch_size`` multiple, executes one chunk per slice at the fixed
        shape, and slices the padding off."""
        return BatchedPlan(self, batch_size, via_vmap=via_vmap)


@dataclasses.dataclass(eq=False)
class BatchedPlan:
    """Serve arbitrary-size macro-batches through fixed-shape chunks.
    Callable exactly like the plan: ``bp(params, *inputs)`` where every
    input's leading axis is the request batch.  The remainder chunk is
    zero-padded and the padding discarded, so every chunk runs at one shape.
    ``via_vmap`` (the JAX package's vmap-over-chunk mode, for graphs whose
    inputs carry no batch dim) has no counterpart here and raises."""

    plan: ExecutionPlan
    batch_size: int
    via_vmap: bool = False

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.via_vmap:
            raise NotImplementedError(
                "via_vmap has no counterpart in the port: the ops take a leading batch dim"
            )
        #: stats of the most recent __call__ (padding overhead is the serving
        #: cost of fixed-shape chunks; surfaced by PlanServer)
        self.last_stats: Dict[str, int] = {}
        #: cumulative over every chunk ever executed; guarded by _lock
        self.total_stats: Dict[str, int] = {"frames": 0, "batches": 0, "padded_frames": 0}
        self._lock = threading.Lock()

    def _validate(self, inputs) -> int:
        if not inputs:
            raise TypeError("batched plan needs at least one input")
        b = inputs[0].shape[0]
        if b == 0:
            raise ValueError("empty macro-batch (leading axis has length 0)")
        for x in inputs[1:]:
            if x.shape[0] != b:
                raise ValueError(f"inconsistent leading batch: {x.shape[0]} vs {b}")
        return int(b)

    def run_chunk(self, params: Dict[str, Dict[str, Any]], *inputs):
        """Execute exactly ONE chunk: the leading axis must be at most
        ``batch_size`` (a short chunk is zero-padded to the fixed shape and
        the padding sliced off the outputs)."""
        b = self._validate(inputs)
        bs = self.batch_size
        if b > bs:
            raise ValueError(f"run_chunk takes at most batch_size={bs} frames, got {b}")
        xs = tuple(torch.as_tensor(x, device=self.plan.device) for x in inputs)
        if b < bs:
            xs = tuple(torch.cat([x, x.new_zeros((bs - b,) + tuple(x.shape[1:]))]) for x in xs)
        out = self.plan(params, *xs)
        with self._lock:
            self.total_stats["frames"] += b
            self.total_stats["batches"] += 1
            self.total_stats["padded_frames"] += bs - b
        if isinstance(out, tuple):
            return tuple(o[:b] for o in out)
        return out[:b]

    def __call__(self, params: Dict[str, Dict[str, Any]], *inputs):
        b = self._validate(inputs)
        bs = self.batch_size
        chunks = [
            self.run_chunk(params, *(x[i : i + bs] for x in inputs))
            for i in range(0, b, bs)
        ]
        self.last_stats = {
            "frames": int(b),
            "batches": len(chunks),
            "padded_frames": int((-b) % bs),
        }
        if isinstance(chunks[0], tuple):
            return tuple(torch.cat([c[j] for c in chunks]) for j in range(len(chunks[0])))
        return torch.cat(chunks)


def compile_plan(
    g: Graph,
    *,
    backend: str = "kernel",
    device: DeviceLike = None,
) -> ExecutionPlan:
    """Compile ``g`` into an :class:`ExecutionPlan` (validates the graph,
    resolves handlers, schedules topologically, computes buffer liveness)
    for ``device`` (``None`` means ``cuda``; raises without a GPU)."""
    if backend not in _HANDLERS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    dev = resolve_device(device)
    # schedule before validating: Graph.validate requires def-before-use node
    # order, which the Kahn schedule establishes for out-of-order builders
    order = _topo_schedule(g)
    g = dataclasses.replace(g, nodes=order)
    g.validate()
    handlers = handlers_for(backend)
    missing = sorted({n.op for n in order if n.op not in handlers})
    if missing:
        raise NotImplementedError(
            f"no {backend!r} handler for ops {missing}; "
            f"registered: {registered_ops(backend)}"
        )
    # liveness: an intermediate dies at its last consuming step.  Graph inputs
    # are caller-owned and graph outputs must survive, so neither is freed.
    keep = set(g.inputs) | set(g.outputs)
    last_use: Dict[str, int] = {}
    for i, n in enumerate(order):
        for x in n.inputs:
            last_use[x] = i
    steps = []
    for i, n in enumerate(order):
        frees = tuple(x for x, j in last_use.items() if j == i and x not in keep)
        steps.append(Step(node=n, frees=frees))
    return ExecutionPlan(graph=g, steps=tuple(steps), backend=backend, device=dev)
