"""Execution plans: op-registry compilation of LR graphs (a port of
``repro.core.graph.executor`` for the slice's ops and backends).

Compilation (:func:`compile_plan`) happens once per graph:

1. **handler resolution** -- every node op is looked up in the op registry
   (:func:`register_op`); unknown ops fail at *compile* time, not mid-run.
   Three handler sets exist: ``kernel`` (the GEMM/conv/fused ops go through
   the hand-written CUDA kernels), ``reference`` (plain torch, the parity
   oracle) and ``quant`` (the kernel set overlaid with the INT8
   ``qlinear`` / ``qconv2d`` handlers: the backend of plans the
   ``quantize`` pass rewrote).  ``guarded`` is a policy over them: each
   step tries the ``quant`` overlay and demotes a failure to its
   ``reference`` handler, on the same device, under circuit breakers
   (:meth:`ExecutionPlan._exec_guarded`).
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
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...convert import DeviceLike, resolve_device
from ...kernels import ops as kops
from ...kernels import ref as kref
from ...obs import metrics as _metrics
from ...obs import trace as _otrace
from ...robustness import faults as _faults
from ...robustness.breaker import GuardConfig, NumericGuardError
from .ir import Graph, Node

__all__ = [
    "BACKENDS",
    "EXEC_BACKENDS",
    "register_op",
    "registered_ops",
    "handlers_for",
    "guard_fallback_counts",
    "reset_guard_fallbacks",
    "Runtime",
    "Step",
    "ExecutionPlan",
    "BatchedPlan",
    "compile_plan",
]

_ACT = kref._ACT

#: ``kernel``: CUDA-kernel-backed GEMM/conv/fused ops.  ``reference``: plain
#: torch (the parity oracle).  ``quant``: the kernel set *overlaid* with the
#: INT8 handlers -- the only backend that executes ``qlinear`` / ``qconv2d``
#: nodes with the INT8 kernels; other ops fall through to their kernel
#: handlers.
BACKENDS = ("kernel", "reference", "quant")

#: executable backends: the registration backends plus ``guarded`` -- a
#: policy backend (no handler table of its own) that tries a primary table
#: (``quant`` overlay by default) per step and demotes failures to the
#: ``reference`` handler under circuit breakers.  See ``_exec_guarded``.
EXEC_BACKENDS = BACKENDS + ("guarded",)

#: backend -> op -> handler(params, inputs, attrs, runtime) -> tensor
_HANDLERS: Dict[str, Dict[str, Callable]] = {b: {} for b in BACKENDS}


def handlers_for(backend: str) -> Dict[str, Callable]:
    """The effective handler table for ``backend`` (``quant`` inherits every
    kernel handler and overrides/extends it with the quantized set;
    ``guarded`` resolves to its default primary table -- the same
    overlay)."""
    if backend in ("quant", "guarded"):
        return {**_HANDLERS["kernel"], **_HANDLERS["quant"]}
    return dict(_HANDLERS[backend])


# --------------------------------------------------------------------------- #
# guarded-execution accounting (process-wide)                                  #
# --------------------------------------------------------------------------- #
#
# Process-wide demotion counts live in the port's metrics registry as the
# ``guard_demotions_total{op, scheme, reason}`` counter family (reason in
# {exception, numeric, breaker_open}); the per-plan breakdown lives in
# ``ExecutionPlan.guard_stats()``.  The accessors below are views over the
# registry.

_GUARD_METRIC = "guard_demotions_total"


def guard_fallback_counts() -> Dict[str, int]:
    """Process-wide guarded-executor demotion counts, keyed
    ``"op/scheme/reason"`` (a view over the ``guard_demotions_total``
    registry family)."""
    counts = _metrics.registry().label_counts(_GUARD_METRIC, "op", "scheme", "reason")
    return {k: int(v) for k, v in counts.items()}


def reset_guard_fallbacks() -> None:
    _metrics.registry().reset(_GUARD_METRIC)


def _node_scheme(n: Node) -> str:
    """The arithmetic scheme a node executes under (``f32``, ``w8``,
    ``w8a8``): the ``scheme`` arg of its step span and the breaker-key
    dimension that separates an INT8 kernel family from its f32 sibling."""
    if n.op in ("qlinear", "qconv2d"):
        s = n.attrs.get("scheme")
        if s:
            return s
        return "w8a8" if n.attrs.get("x_scale") is not None else "w8"
    return "f32"


def _check_finite(y: torch.Tensor) -> None:
    """Post-step numeric guard: raise :class:`NumericGuardError` when a
    floating step output holds NaN/Inf.  On the card this is a host sync
    per step (``.item()`` waits for the step's kernels)."""
    if y.is_floating_point() and not bool(torch.isfinite(y).all().item()):
        raise NumericGuardError("non-finite values in step output")


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
#   ("norm_rms", pkey, eps)          decoder RMSNorm (scale only)
#   ("rope", j, heads, theta)        RoPE by the position ids in input j


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
        elif kind == "norm_rms":  # decoder RMSNorm: scale-only, no bias param
            pkey, eps = step[1], step[2]
            norms.append((p[f"{pkey}_scale"], None))
            out.append((kind, len(norms) - 1, eps))
        elif kind == "rope":  # position ids stream in as a side operand
            sides.append(xs[step[1]])
            out.append((kind, len(sides) - 1, step[2], step[3]))
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
    planes; a rope step needs whole heads; broadcast sides are not
    output-shaped) -- callers then run the kernel without it and apply
    :func:`_apply_epilogue` after, so the kernel and reference backends
    round at the same places (the JAX package's rule)."""
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
        else:  # norm_layer / norm_instance / norm_rms / rope
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
    """colcompact / channelcompact: the dense-matmul kernel on the compact
    weight.  pbcsr: the band-dispatched block-sparse kernel.  Tile-fusable
    epilogues run on the f32 accumulator inside the kernel (for pbcsr, in
    every band's launch); norm / rope steps and broadcast sides run as the
    plain tail after it."""
    fmt = a["format"]
    if fmt not in ("colcompact", "channelcompact", "pbcsr"):
        raise NotImplementedError(f"sparse format {fmt}")
    epi = a.get("epilogue") or ()
    values = p["values"]
    if fmt == "pbcsr":
        nb, _, _, bn = values.shape
        out_shape = (*xs[0].shape[:-1], nb * bn)
    else:
        out_shape = (*xs[0].shape[:-1], values.shape[1])
    steps, sides = _kernel_epilogue(epi, xs, out_shape)
    kw = dict(activation=a.get("activation"))
    if steps is not None:
        kw.update(epilogue=steps, epilogue_sides=sides)
    if fmt == "colcompact":
        y = kops.col_matmul(xs[0], values, p["kept"], p.get("b"), **kw)
    elif fmt == "channelcompact":
        y = kops.matmul(xs[0], values, p.get("b"), **kw)
    else:
        y = kops.bsr_matmul(xs[0], values, p["block_rows"], p.get("b"), bands=a.get("bands"),
                            **kw)
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
    elif fmt == "pbcsr":
        x = xs[0]
        y = kref.bsr_matmul_ref(
            x.reshape(-1, x.shape[-1]), p["values"], p["block_rows"], p.get("b"),
            activation=a.get("activation"),
        ).reshape(*x.shape[:-1], -1)
    else:
        raise NotImplementedError(f"sparse format {fmt}")
    return _apply_epilogue(y, a.get("epilogue") or (), xs, p)


def _conv_out_shape(p, xs, a, wkey="w"):
    x, w = xs[0], p[wkey]
    oh, ow = kops.conv_out_hw(
        x.shape[2], x.shape[3], w.shape[2], w.shape[3],
        a.get("stride", 1), a.get("padding", "SAME"),
    )
    return (x.shape[0], w.shape[0], oh, ow)


def _conv_call_kwargs(p, a):
    """Shared kwarg plumbing for the conv kernel handlers (``_format`` keys
    the tuning cache, as in the JAX package)."""
    return dict(
        stride=a.get("stride", 1), padding=a.get("padding", "SAME"),
        groups=a.get("groups", 1), dilation=a.get("dilation", 1),
        kept=p.get("kept"), activation=a.get("activation"),
        _format=a.get("format", "dense"),
    )


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
    kw = _conv_call_kwargs(p, a)
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
# handlers: quantized GEMM family (produced by the ``quantize`` pass)          #
# --------------------------------------------------------------------------- #
#
# ``qlinear`` node contract -- params: ``values`` int8 [K', N] (+ ``kept``
# for colcompact, ``b`` f32), ``w_scale`` f32 [N]; attrs: ``format`` in
# {dense, colcompact, channelcompact}, ``scheme`` in {w8, w8a8} (+
# ``x_scale`` float when w8a8), plus the usual activation/epilogue attrs and
# a ``bytes_saved`` annotation from the pass.  ``qconv2d`` likewise, with
# ``values`` int8 [O, C', kh, kw] and ``w_scale`` [O].


@register_op("qlinear", backends=("quant",))
def _qlinear_quant(p, xs, a, rt):
    """INT8 kernel path: W8A8 (int32 sums) when the node carries a
    calibrated activation scale, else W8 (int8 weights, f32 activations)."""
    x = xs[0]
    if a.get("format") == "colcompact":
        x = x.index_select(-1, p["kept"])
    epi = a.get("epilogue") or ()
    out_shape = (*xs[0].shape[:-1], p["values"].shape[1])
    steps, sides = _kernel_epilogue(epi, xs, out_shape)
    kw = dict(x_scale=a.get("x_scale"), activation=a.get("activation"),
              _format=a.get("format", "dense"))
    if steps is not None:
        kw.update(epilogue=steps, epilogue_sides=sides)
    y = kops.qmatmul(x, p["values"], p["w_scale"], p.get("b"), **kw)
    return y if steps is not None else _apply_epilogue(y, epi, xs, p)


@register_op("qlinear", backends=("reference",))
def _qlinear_ref(p, xs, a, rt):
    """Plain oracle: dequantized weights (and fake-quantized activations
    for w8a8) through the f32 reference GEMM."""
    x = xs[0]
    if a.get("format") == "colcompact":
        x = x.index_select(-1, p["kept"])
    y = kref.qmatmul_ref(
        x, p["values"], p["w_scale"], p.get("b"),
        x_scale=a.get("x_scale"), activation=a.get("activation"),
    )
    return _apply_epilogue(y, a.get("epilogue") or (), xs, p)


@register_op("qconv2d", backends=("quant",))
def _qconv2d_quant(p, xs, a, rt):
    """INT8 implicit-GEMM conv: W8A8 (int8 patches x int8 filters, int32
    sums) when the node carries a calibrated activation scale, else W8
    (int8 filters converted on chip) -- the f32 filter copy never
    materializes in device memory."""
    epi = a.get("epilogue") or ()
    steps, sides = _kernel_epilogue(epi, xs, _conv_out_shape(p, xs, a, "values"))
    kw = _conv_call_kwargs(p, a)
    kw.update(w_scale=p["w_scale"], x_scale=a.get("x_scale"))
    if steps is not None:
        kw.update(epilogue=steps, epilogue_sides=sides)
    y = kops.conv2d(xs[0], p["values"], p.get("b"), **kw)
    return y if steps is not None else _apply_epilogue(y, epi, xs, p)


@register_op("qconv2d", backends=("reference",))
def _qconv2d_ref(p, xs, a, rt):
    """Plain oracle: dequantized filters (and fake-quantized activations for
    w8a8) through the f32 reference conv."""
    x = xs[0]
    if p.get("kept") is not None:
        x = x.index_select(1, p["kept"])
    y = kref.qconv2d_ref(
        x, p["values"], p["w_scale"], p.get("b"), x_scale=a.get("x_scale"),
        stride=a.get("stride", 1), padding=a.get("padding", "SAME"),
        groups=a.get("groups", 1), dilation=a.get("dilation", 1),
        activation=a.get("activation"),
    )
    return _apply_epilogue(y, a.get("epilogue") or (), xs, p)


# --------------------------------------------------------------------------- #
# handlers: shared ops (same implementation on every backend)                  #
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
# handlers: decoder-block ops (the transformer lowering)                       #
# --------------------------------------------------------------------------- #
#
# Node contracts (see models/transformer_graph.py, the builder):
#
#   embed      in (tokens [B, S] int),              params {table [V, D]}
#   rmsnorm    in (x [..., D]),                     params {scale [D]}, attrs eps
#   rope       in (x [..., S, H*dh], pos [..., S]), attrs heads, theta
#   attention  phase="prefill": in (q, k, v [B, S, H|G * dh], lengths [B])
#              phase="decode":  in (q [B, 1, H*dh], k_new, v_new [B, 1, G*dh],
#                                   k_ctx, v_ctx [B, L, S, G, dh], lengths [B])
#              attrs n_heads, n_kv_heads (+ layer for decode)
#   ffn        in (x [..., D]),  params {w_gate, w_up [D, F]}, attrs activation
#   unembed    in (x [..., D]),  params {w [D, V_pad]}, attrs vocab
#
# ``lengths`` is the live token count per row: prefill masks each row to its
# own prompt (the batch is padded to a common S), decode masks the gathered
# page span and places the new token at slot == length (so the valid prefix
# stays contiguous -- ``gqa_decode_step``'s slot = pos semantics).


def _attn_heads(q, k, v, a, *, repeat: bool = True):
    """[B, S, H*dh] projections -> [B, H, S, dh] head views (no copy).  With
    ``repeat`` the KV groups are repeated to the query head count (GQA: head
    gi*rep+ri reads group gi, the ``q.reshape(b, s, g, rep, dh)`` grouping
    of models/attention.py); without it k/v keep their G heads and the
    attention kernel reads group ``h // rep`` itself."""
    h, g = a["n_heads"], a["n_kv_heads"]
    b, s, hd = q.shape
    dh = hd // h
    qh = q.reshape(b, s, h, dh).transpose(1, 2)
    kh = k.reshape(b, k.shape[1], g, dh).transpose(1, 2)
    vh = v.reshape(b, v.shape[1], g, dh).transpose(1, 2)
    if repeat and g != h:
        kh = kh.repeat_interleave(h // g, dim=1)
        vh = vh.repeat_interleave(h // g, dim=1)
    return qh, kh, vh, (b, s, hd)


def _attn_decode_merge(xs, a, *, repeat: bool = True):
    """Merge the step's fresh k/v into the gathered cache span at
    slot == length, then head-split.  Returns (qh, kh, vh, shape, lengths+1).
    The span is the cache's type (f32) and the fresh k/v the model's:
    ``torch.where`` promotes to the wider, as ``jnp.where`` does."""
    q, k_new, v_new, k_ctx, v_ctx, lengths = xs
    g = a["n_kv_heads"]
    dh = k_new.shape[-1] // g
    kc = k_ctx[:, a["layer"]]  # [B, S, G, dh]
    vc = v_ctx[:, a["layer"]]
    b, s_ctx = kc.shape[0], kc.shape[1]
    slot = (
        torch.arange(s_ctx, dtype=torch.int32, device=kc.device)[None, :, None, None]
        == lengths[:, None, None, None]
    )
    k = torch.where(slot, k_new.reshape(b, 1, g, dh), kc).reshape(b, s_ctx, -1)
    v = torch.where(slot, v_new.reshape(b, 1, g, dh), vc).reshape(b, s_ctx, -1)
    qh, kh, vh, shape = _attn_heads(q, k, v, a, repeat=repeat)
    return qh, kh, vh, shape, lengths + 1


def _merge_heads(out, shape):
    b, s, hd = shape
    return out.transpose(1, 2).reshape(b, s, hd)


@register_op("attention", backends=("kernel",))
def _attention_kernel(p, xs, a, rt):
    """The flash-attention kernel over the KV groups as they are (no repeat,
    no padding): prefill causal with per-row lengths, decode one query row
    against the merged span with lengths + 1."""
    if a.get("phase") == "decode":
        qh, kh, vh, shape, lens = _attn_decode_merge(xs, a, repeat=False)
        out = kops.attention(qh, kh, vh, lens, causal=False)
    else:
        q, k, v, lengths = xs
        qh, kh, vh, shape = _attn_heads(q, k, v, a, repeat=False)
        out = kops.attention(qh, kh, vh, lengths, causal=True)
    return _merge_heads(out, shape)


@register_op("attention", backends=("reference",))
def _attention_ref(p, xs, a, rt):
    """Plain oracle (naive masked softmax at f32) -- also the meta-tensor
    body ``memory_estimate`` walks."""
    if a.get("phase") == "decode":
        qh, kh, vh, shape, lens = _attn_decode_merge(xs, a)
        out = kref.flash_attention_ref(qh, kh, vh, lens, causal=False)
    else:
        q, k, v, lengths = xs
        qh, kh, vh, shape = _attn_heads(q, k, v, a)
        out = kref.flash_attention_ref(qh, kh, vh, lengths, causal=True)
    return _merge_heads(out, shape)


@register_op("embed")
def _embed(p, xs, a, rt):
    return p["table"][xs[0].long()]


@register_op("rmsnorm")
def _rmsnorm(p, xs, a, rt):
    # identical math to models/layers.rmsnorm: f32 compute, cast back
    # *before* the scale multiply
    x = xs[0]
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + a.get("eps", 1e-6))).to(x.dtype) * p["scale"]


@register_op("rope")
def _rope(p, xs, a, rt):
    return kref.rope_ref(xs[0], xs[1], a["heads"], a.get("theta", 10000.0))


@register_op("ffn", backends=("kernel",))
def _ffn_kernel(p, xs, a, rt):
    return kops.ffn_gateup(xs[0], p["w_gate"], p["w_up"], activation=a.get("activation", "silu"))


@register_op("ffn", backends=("reference",))
def _ffn_ref(p, xs, a, rt):
    return kref.ffn_gateup_ref(
        xs[0], p["w_gate"], p["w_up"], activation=a.get("activation", "silu")
    )


@register_op("unembed")
def _unembed(p, xs, a, rt):
    # model-dtype product (outside any kernel, as the JAX package leaves it
    # to XLA), pad-vocab classes masked: transformer._unembed's math
    logits = xs[0] @ p["w"]
    v, vp = a["vocab"], p["w"].shape[1]
    if v != vp:
        keep = torch.arange(vp, device=logits.device) < v
        logits = torch.where(keep, logits, torch.full((), -1e30, dtype=logits.dtype,
                                                      device=logits.device))
    return logits


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
    #: guarded-backend knobs; only meaningful (and auto-defaulted) when
    #: ``backend == "guarded"``
    guard: Optional[GuardConfig] = None

    def __post_init__(self):
        self._rt = Runtime(backend=self.backend)
        if self.backend == "guarded":
            if self.guard is None:
                self.guard = GuardConfig()
            self._handlers = handlers_for(self.guard.primary)
            self._ref_handlers = handlers_for("reference")
            self._guard_lock = threading.Lock()
            #: (op, scheme) -> CircuitBreaker, created lazily per step family
            self._breakers: Dict[Tuple[str, str], Any] = {}
            self.guard_counters: Dict[str, Any] = {
                "primary_ok": 0,
                "fallbacks": 0,
                "breaker_short_circuits": 0,
                "numeric_guard_trips": 0,
                "by_key": {},
            }
        else:
            if self.guard is not None:
                raise ValueError(
                    f"guard config requires backend='guarded', got {self.backend!r}"
                )
            self._handlers = handlers_for(self.backend)

    # -- execution ----------------------------------------------------------- #
    def __call__(self, params: Dict[str, Dict[str, Any]], *args):
        return self.run_steps(params, *args)

    def run_steps(
        self,
        params: Dict[str, Dict[str, Any]],
        *args,
        observer: Optional[Callable[[str, Any], None]] = None,
    ):
        """Execute the plan: one handler call per step, dead intermediates
        dropped right after their last use.  ``observer(name, value)`` (if
        given) sees every graph input and node output as it is produced --
        the calibration hook of :func:`repro_torch.quant.calibrate_plan`."""
        if len(args) != len(self.graph.inputs):
            raise TypeError(
                f"plan expects {len(self.graph.inputs)} inputs "
                f"{self.graph.inputs}, got {len(args)}"
            )
        env: Dict[str, Any] = {
            name: torch.as_tensor(x, device=self.device)
            for name, x in zip(self.graph.inputs, args)
        }
        if observer is not None:
            for name, v in env.items():
                observer(name, v)
        guarded = self.backend == "guarded"
        if _otrace.enabled():  # one branch per run when tracing is off
            return self._run_steps_traced(env, params, observer, guarded)
        for step in self.steps:
            n = step.node
            xs = [env[i] for i in n.inputs]
            p = params.get(n.name, {})
            if guarded:
                env[n.name] = self._exec_guarded(n, p, xs)
            else:
                env[n.name] = self._handlers[n.op](p, xs, n.attrs, self._rt)
            del xs
            if observer is not None:
                observer(n.name, env[n.name])
            for f in step.frees:  # dead intermediate: release our reference
                del env[f]
        outs = tuple(env[o] for o in self.graph.outputs)
        return outs[0] if len(outs) == 1 else outs

    def _run_steps_traced(self, env, params, observer, guarded):
        """The traced twin of the ``run_steps`` loop: one ``cat="plan"``
        span around the run, one ``cat="step"`` span per step carrying op /
        scheme / backend / output shape, demotions annotated in-span (the
        ``demoted`` arg + a nested ``cat="guard"`` instant)."""
        with _otrace.span(
            "plan", cat="plan", backend=self.backend, steps=len(self.steps),
            outputs=list(self.graph.outputs),
        ):
            for step in self.steps:
                n = step.node
                xs = [env[i] for i in n.inputs]
                p = params.get(n.name, {})
                with _otrace.span(n.name, cat="step", op=n.op, scheme=_node_scheme(n),
                                  backend=self.backend) as sp:
                    if guarded:
                        y = self._exec_guarded(n, p, xs, sp)
                    else:
                        y = self._handlers[n.op](p, xs, n.attrs, self._rt)
                    sp.set("out_shape", list(y.shape))
                del xs
                env[n.name] = y
                if observer is not None:
                    observer(n.name, y)
                for f in step.frees:
                    del env[f]
        outs = tuple(env[o] for o in self.graph.outputs)
        return outs[0] if len(outs) == 1 else outs

    # -- guarded execution ---------------------------------------------------- #
    def _exec_guarded(self, n: Node, p, xs, sp=_otrace.NULL_SPAN):
        """One step under the guarded contract: try the primary (kernel)
        handler behind the step family's circuit breaker and fault-injection
        hook; on any exception or a numeric-guard trip, record the failure
        and demote to the ``reference`` handler for this step only -- the
        plain-torch version on the same tensors, so on the same device.  The
        reference handler's own exception propagates (nothing hides a
        broken device).  Shared ops (same function object on both backends)
        run unguarded -- there is nothing to demote to."""
        cfg = self.guard
        ref = self._ref_handlers.get(n.op)
        primary = self._handlers.get(n.op, ref)
        if ref is None or primary is ref:
            return primary(p, xs, n.attrs, self._rt)
        key = (n.op, _node_scheme(n))
        with self._guard_lock:
            br = self._breakers.get(key)
            if br is None:
                br = self._breakers[key] = cfg.make_breaker()
            allowed = br.allow()
        if not allowed:
            self._count_guard(key, "breaker_open", sp)
            return ref(p, xs, n.attrs, self._rt)
        fn = _faults.wrap_handler(n.op, primary)
        try:
            y = fn(p, xs, n.attrs, self._rt)
            if cfg.numeric_guards:
                _check_finite(y)
        except Exception as e:  # demote: any failure mode of the primary
            with self._guard_lock:
                br.record_failure()
            self._count_guard(
                key, "numeric" if isinstance(e, NumericGuardError) else "exception", sp
            )
            return ref(p, xs, n.attrs, self._rt)
        with self._guard_lock:
            br.record_success()
            self.guard_counters["primary_ok"] += 1
        return y

    def _count_guard(self, key: Tuple[str, str], reason: str, sp=_otrace.NULL_SPAN) -> None:
        gkey = f"{key[0]}/{key[1]}/{reason}"
        with self._guard_lock:
            c = self.guard_counters
            c["fallbacks"] += 1
            if reason == "breaker_open":
                c["breaker_short_circuits"] += 1
            elif reason == "numeric":
                c["numeric_guard_trips"] += 1
            c["by_key"][gkey] = c["by_key"].get(gkey, 0) + 1
        _metrics.registry().counter(_GUARD_METRIC, op=key[0], scheme=key[1], reason=reason).inc()
        if _otrace.enabled():
            sp.set("demoted", reason)  # annotate the enclosing step span
            _otrace.instant(f"demote:{key[0]}", cat="guard", scheme=key[1], reason=reason)

    def guard_stats(self) -> Dict[str, Any]:
        """Snapshot of this plan's guarded-execution state: demotion
        counters plus every breaker's state machine -- the payload
        ``AsyncPlanServer.health()`` surfaces per plan."""
        if self.backend != "guarded":
            return {}
        with self._guard_lock:
            c = self.guard_counters
            return {
                "counters": {
                    **{k: v for k, v in c.items() if k != "by_key"},
                    "by_key": dict(c["by_key"]),
                },
                "breakers": {
                    f"{op}/{scheme}": br.snapshot()
                    for (op, scheme), br in self._breakers.items()
                },
            }

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
        # per-dtype breakdown: quantized plans show their int8 payloads here
        param_bytes_by_dtype: Dict[str, int] = {}
        for v in leaves:
            key = str(v.dtype).replace("torch.", "")
            param_bytes_by_dtype[key] = param_bytes_by_dtype.get(key, 0) + _nbytes(v)
        weight_bytes_saved = sum(int(n.attrs.get("bytes_saved", 0)) for n in self.graph.nodes)
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
            "weight_bytes_saved": int(weight_bytes_saved),
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
    guard: Optional[GuardConfig] = None,
) -> ExecutionPlan:
    """Compile ``g`` into an :class:`ExecutionPlan` (validates the graph,
    resolves handlers, schedules topologically, computes buffer liveness)
    for ``device`` (``None`` means ``cuda``; raises without a GPU).
    ``backend="guarded"`` compiles a degradation-tolerant plan: each step
    tries ``guard.primary``'s handler and demotes failures to
    ``reference`` (see :meth:`ExecutionPlan._exec_guarded`)."""
    if backend not in _HANDLERS and backend != "guarded":
        raise ValueError(f"unknown backend {backend!r}; have {EXEC_BACKENDS}")
    dev = resolve_device(device)
    # schedule before validating: Graph.validate requires def-before-use node
    # order, which the Kahn schedule establishes for out-of-order builders
    order = _topo_schedule(g)
    g = dataclasses.replace(g, nodes=order)
    g.validate()
    handlers = handlers_for(backend)
    if backend == "guarded":  # an op with only a reference handler still runs
        handlers = {**handlers, **handlers_for("reference")}
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
    return ExecutionPlan(graph=g, steps=tuple(steps), backend=backend, device=dev, guard=guard)
