"""Public wrappers around the port's kernels (a port of ``repro.kernels.ops``
for the ported paths).

These do the layout work so the executor calls one function per op:
leading-batch flattening, the 1x1-conv direct-GEMM fast path, the conv
fallback matrix, the block-sparse matmul's band dispatch, the decoder's
attention and gated-FFN calls, and the INT8 schemes' activation
quantization (W8A8 activations are quantized here, before the kernel, as
the JAX wrappers do, and their scale is folded into the kernel's
per-column rescale).  Each
routes to a kernel wrapper in this package, whose device picks the route
(CPU tensor: plain version; CUDA tensor: the CUDA kernel or an error).

Differences from the JAX wrappers, by design:

* no padding to block multiples -- the CUDA kernels mask ragged edges;
* no block-size tuning cache -- the kernels pick fixed tiles for the card
  (the cache comes with the port of ``launch/tune``);
* the conv fallback matrix keeps ``groups`` / ``dilation`` / ``padding`` /
  ``degenerate`` and routes them to the plain version (never to a library
  convolution), counted in ``conv_fallback_total{reason}`` as the JAX
  package counts its ``lax.conv`` route.  Its TPU-only ``vmem`` reason is
  gone: the CUDA kernel tiles its own shared memory at any width;
* ``bsr_matmul``'s bands write into one preallocated output (no concat),
  and an empty band runs the kernel's epilogue-only launch instead of a
  plain-torch epilogue of zeros.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..obs import metrics as _metrics
from ..quant.qtensor import fake_quant, quantize_array, scale_tensor
from . import bsr_matmul as _bsr_mod
from . import conv2d as _conv2d_mod
from . import dense_matmul as _dense_mod
from . import flash_attention as _flash_mod
from . import fused_elementwise as _fused_mod
from . import fused_ffn as _ffn_mod
from . import quant_matmul as _quant_mod
from .conv2d import conv2d_gemm as _conv2d_gemm
from .conv2d import conv_out_hw, conv_pad_hw, conv_padding_token
from .dense_matmul import dense_matmul as _dense_matmul
from .fused_elementwise import fused_elementwise as _fused_elementwise
from .quant_matmul import quant_matmul as _quant_matmul
from .ref import apply_steps_ref, conv2d_ref

__all__ = [
    "matmul",
    "col_matmul",
    "bsr_matmul",
    "qmatmul",
    "conv2d",
    "fused_elementwise",
    "ffn_gateup",
    "attention",
    "conv_out_hw",
    "conv_pad_hw",
    "conv_padding_token",
    "conv_gemm1x1_elected",
    "conv_fallback_reason",
    "conv_fallback_counts",
    "reset_conv_fallbacks",
    "conv_fastpath_counts",
    "reset_conv_fastpaths",
    "kernel_launch_counts",
    "conv_scheme_launch_counts",
    "dense_dtype_launch_counts",
    "reset_kernel_launches",
]

#: kernel modules by the name their launch count is reported under
_KERNEL_MODULES = {
    "conv2d": _conv2d_mod,
    "dense_matmul": _dense_mod,
    "fused_elementwise": _fused_mod,
    "quant_matmul": _quant_mod,
    "flash_attention": _flash_mod,
    "ffn_gateup": _ffn_mod,
    "bsr_matmul": _bsr_mod,
}


def kernel_launch_counts() -> Dict[str, int]:
    """CUDA kernel launches per kernel since the last reset (CPU calls that
    take the plain versions launch nothing and count nothing)."""
    return {name: mod.launches for name, mod in _KERNEL_MODULES.items()}


def conv_scheme_launch_counts() -> Dict[str, int]:
    """The conv kernel's launches since the last reset, by scheme (``f32``
    -- channel-pruned included -- ``w8``, ``w8a8``)."""
    return dict(_conv2d_mod.scheme_launches)


def dense_dtype_launch_counts() -> Dict[str, int]:
    """The dense-matmul kernel's launches since the last reset, by element
    type (``f32``, ``bf16``)."""
    return dict(_dense_mod.dtype_launches)


def reset_kernel_launches() -> None:
    for mod in _KERNEL_MODULES.values():
        mod.launches = 0
    for dtype in _dense_mod.dtype_launches:
        _dense_mod.dtype_launches[dtype] = 0
    for scheme in _conv2d_mod.scheme_launches:
        _conv2d_mod.scheme_launches[scheme] = 0


# --------------------------------------------------------------------------- #
# conv routing counters (metrics-registry views, as in the JAX package)        #
# --------------------------------------------------------------------------- #

_CONV_FALLBACK_METRIC = "conv_fallback_total"
_CONV_FASTPATH_METRIC = "conv_fastpath_total"


def conv_fallback_counts() -> Dict[str, int]:
    """reason -> count of convs routed to the plain version."""
    counts = _metrics.registry().label_counts(_CONV_FALLBACK_METRIC, "reason")
    return {k: int(v) for k, v in counts.items()}


def reset_conv_fallbacks() -> None:
    _metrics.registry().reset(_CONV_FALLBACK_METRIC)


def conv_fastpath_counts() -> Dict[str, int]:
    """scheme -> count of convs elected onto the 1x1 direct-GEMM path."""
    counts = _metrics.registry().label_counts(_CONV_FASTPATH_METRIC, "scheme")
    return {k: int(v) for k, v in counts.items()}


def reset_conv_fastpaths() -> None:
    _metrics.registry().reset(_CONV_FASTPATH_METRIC)


# --------------------------------------------------------------------------- #
# GEMM family                                                                  #
# --------------------------------------------------------------------------- #


def matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    activation: Optional[str] = None,
    epilogue: Sequence[Tuple] = (),
    epilogue_sides: Sequence[torch.Tensor] = (),
) -> torch.Tensor:
    """``epilogue(act(x @ w + bias))`` for arbitrary leading batch dims
    through the dense-matmul kernel.  ``epilogue_sides`` are shaped like the
    output (or its flattened ``[M, N]`` view)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    m, n = x2.shape[0], w.shape[1]
    sides2 = []
    for s in epilogue_sides:
        if tuple(s.shape) not in ((*lead, n), (m, n)):
            raise ValueError(f"matmul: side {tuple(s.shape)} vs output {(*lead, n)}")
        sides2.append(s.reshape(m, n).contiguous())
    out = _dense_matmul(
        x2, w.contiguous(), bias, *sides2, activation=activation,
        epilogue=tuple(tuple(s) for s in epilogue),
    )
    return out.reshape(*lead, n)


def col_matmul(
    x: torch.Tensor,
    values: torch.Tensor,
    kept: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    activation: Optional[str] = None,
    epilogue: Sequence[Tuple] = (),
    epilogue_sides: Sequence[torch.Tensor] = (),
) -> torch.Tensor:
    """Column-pruned ``act(x @ W + bias)``: static input gather + the
    strictly smaller dense GEMM.  ``values [K_kept, N]``."""
    return matmul(
        x.index_select(-1, kept), values, bias, activation=activation,
        epilogue=epilogue, epilogue_sides=epilogue_sides,
    )


def bsr_matmul(
    x: torch.Tensor,
    values: torch.Tensor,
    block_rows: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    activation: Optional[str] = None,
    epilogue: Sequence[Tuple] = (),
    epilogue_sides: Sequence[torch.Tensor] = (),
    bands: Optional[Sequence[Tuple[int, int, int]]] = None,
) -> torch.Tensor:
    """Block-sparse ``epilogue(act(x @ W + bias))`` over PBCSR-packed weights
    for arbitrary leading batch dims.

    ``bands`` (from the reorder pass): ``(start, stop, count)`` over output
    block-columns, in order and covering all of them; one kernel launch per
    band with the exact trip count ``count`` -- an empty band (``count ==
    0``) launches too and outputs only the epilogue of a zero accumulator.
    Without bands, one launch over every column with all ``S`` steps.  Each
    launch writes its band's columns of one output (no concat) and reads
    the bias and side operands at those columns.  ``epilogue`` is the
    :func:`matmul` step program, run on the f32 accumulator in each band's
    launch.  The plain route (CPU tensors) walks the same band loop."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    m = x2.shape[0]
    nb, s, _, bn = values.shape
    n = nb * bn
    sides2 = []
    for sv in epilogue_sides:
        if tuple(sv.shape) not in ((*lead, n), (m, n)):
            raise ValueError(f"bsr_matmul: side {tuple(sv.shape)} vs output {(*lead, n)}")
        sides2.append(sv.reshape(m, n).contiguous())
    bands = tuple(tuple(int(v) for v in b) for b in bands) if bands else ((0, nb, s),)
    covered = 0
    for start, stop, _ in bands:
        if start != covered or stop < start:
            raise ValueError(f"bsr_matmul: bands {bands} do not tile {nb} block-columns")
        covered = stop
    if covered != nb:
        raise ValueError(f"bsr_matmul: bands {bands} do not tile {nb} block-columns")
    epilogue = tuple(tuple(st) for st in epilogue)
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    for band in bands:
        if band[1] > band[0]:
            _bsr_mod.bsr_matmul(
                x2, values, block_rows, bias, *sides2, activation=activation,
                epilogue=epilogue, band=band, out=out,
            )
    return out.reshape(*lead, n)


def qmatmul(
    x: torch.Tensor,
    w_q: torch.Tensor,
    w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    x_scale: Optional[float] = None,
    activation: Optional[str] = None,
    epilogue: Sequence[Tuple] = (),
    epilogue_sides: Sequence[torch.Tensor] = (),
) -> torch.Tensor:
    """Quantized ``epilogue(act((x @ w_q) * scales + bias))`` for arbitrary
    leading batch dims through the INT8 matmul kernel.

    ``w_q [K, N]`` int8 with per-output-channel ``w_scale [N]`` f32.  With
    ``x_scale`` (the calibrated static activation scale, a Python float) the
    f32 activations are quantized to int8 here and the kernel sums int8 x
    int8 products in int32 (**W8A8**); the activation scale is folded into
    the per-column rescale, ``w_scale * x_scale`` in f32.  Without it the
    activations stay f32 and only the weights are int8 (**W8**)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    m, n = x2.shape[0], w_q.shape[1]
    sides2 = []
    for s in epilogue_sides:
        if tuple(s.shape) not in ((*lead, n), (m, n)):
            raise ValueError(f"qmatmul: side {tuple(s.shape)} vs output {(*lead, n)}")
        sides2.append(s.reshape(m, n).contiguous())
    ws = w_scale.float()
    if x_scale is not None:
        s = scale_tensor(x_scale, x2)
        x2 = quantize_array(x2, s)
        ws = ws * s
    out = _quant_matmul(
        x2, w_q.contiguous(), ws.contiguous(), bias, *sides2, activation=activation,
        epilogue=tuple(tuple(s) for s in epilogue),
    )
    return out.reshape(*lead, n)


# --------------------------------------------------------------------------- #
# conv2d                                                                       #
# --------------------------------------------------------------------------- #


def conv_gemm1x1_elected(kh: int, kw: int, groups: int, padding, c: int) -> bool:
    """True when a conv lowers through the 1x1 direct-GEMM fast path: unit
    taps, ungrouped, live input channels, and padding that adds no border
    (SAME == VALID for 1x1 taps; explicit pads must be all-zero)."""
    if kh != 1 or kw != 1 or groups != 1 or c <= 0:
        return False
    if isinstance(padding, str):
        return padding in ("SAME", "VALID")
    try:
        (a, b), (c2, d) = padding
        return int(a) == int(b) == int(c2) == int(d) == 0
    except (TypeError, ValueError):
        return False


def conv_fallback_reason(
    c: int, h: int, w: int, kh: int, kw: int, stride: int, padding,
    *, groups: int = 1, dilation: int = 1,
) -> Optional[str]:
    """The conv fallback matrix: the reason a conv cannot take the kernel
    (``groups`` / ``dilation`` / ``padding`` / ``degenerate``), or None.
    ``c`` is the contracted channel count."""
    if groups != 1:
        return "groups"
    if dilation != 1:
        return "dilation"
    if not isinstance(padding, str):
        try:
            (a, b), (c2, d) = padding
            if min(int(a), int(b), int(c2), int(d)) < 0:
                return "padding"  # lax allows negative (cropping) pads; the kernel does not
        except (TypeError, ValueError):
            return "padding"
    try:
        oh, ow = conv_out_hw(h, w, kh, kw, stride, padding)
    except (TypeError, ValueError):
        return "padding"
    if oh < 1 or ow < 1:
        return "degenerate"
    return None


def _conv2d_fallback(x, w, bias, *, stride, padding, kept, w_scale, x_scale, groups,
                     dilation, activation, epilogue, sides):
    """The plain route for configs outside the kernel's matrix -- the same
    math as the reference handlers (channel gather, dequant / fake-quant for
    int8 weights, conv, step tail)."""
    if kept is not None:
        x = x.index_select(1, kept)
    if w.dtype == torch.int8:
        w = w.float() * w_scale.float()[:, None, None, None]
        if x_scale is not None:
            x = fake_quant(x.float(), x_scale)
    y = conv2d_ref(x, w, bias, stride=stride, padding=padding, groups=groups,
                   dilation=dilation, activation=activation, out_dtype=torch.float32)
    if epilogue:
        y = apply_steps_ref(y, epilogue, [s.float() for s in sides])
    return y.to(x.dtype)


def _conv2d_1x1_gemm(x, w, bias, *, stride, kept, w_scale, x_scale, activation, epilogue,
                     sides):
    """The 1x1 direct-GEMM fast path: a unit-tap conv with no border padding
    is ``y[n, :, i, j] = W @ x[n, :, i*s, j*s]`` -- a plain GEMM over the
    ``N*OH*OW`` pixel axis.  NCHW is permuted to pixel-major ``[P, C]`` (the
    stride subsamples the grid first), the OIHW filter collapses to
    ``[C, O]``, and bias / activation / epilogue with its side operands ride
    the dense-matmul kernel (f32) or the quant-matmul kernel (int8 weights,
    with the conv's ``w_scale`` / ``x_scale``).  The permutes around it are
    plain torch."""
    if kept is not None:
        x = x.index_select(1, kept)
    if stride > 1:
        x = x[:, :, ::stride, ::stride]
    nb, c, oh, ow = x.shape
    o = w.shape[0]
    if w.shape[1] != c:
        raise ValueError(f"conv2d: w {tuple(w.shape)} vs {c} live input channels")
    for s in sides:
        if tuple(s.shape) != (nb, o, oh, ow):
            raise ValueError(f"conv2d: side {tuple(s.shape)} != {(nb, o, oh, ow)}")
    xm = x.permute(0, 2, 3, 1).reshape(nb * oh * ow, c)
    wm = w.reshape(o, c).t()
    sm = [s.permute(0, 2, 3, 1).reshape(nb * oh * ow, o) for s in sides]
    if w.dtype == torch.int8:
        y = qmatmul(xm, wm, w_scale, bias, x_scale=x_scale, activation=activation,
                    epilogue=epilogue, epilogue_sides=sm)
    else:
        y = matmul(xm, wm, bias, activation=activation, epilogue=epilogue, epilogue_sides=sm)
    return y.reshape(nb, oh, ow, o).permute(0, 3, 1, 2).contiguous()


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding="SAME",
    kept: Optional[torch.Tensor] = None,
    w_scale: Optional[torch.Tensor] = None,
    x_scale: Optional[float] = None,
    groups: int = 1,
    dilation: int = 1,
    activation: Optional[str] = None,
    epilogue: Sequence[Tuple] = (),
    epilogue_sides: Sequence[torch.Tensor] = (),
) -> torch.Tensor:
    """``epilogue(act(conv2d(x, w) + bias))``: ``x [N, C, H, W]`` NCHW,
    ``w [O, C', kh, kw]`` OIHW, SAME/VALID/explicit ``padding``, square
    ``stride``; ``kept`` (live input-channel indices of a channel-pruned
    conv) makes the kernel contract only ``C' = len(kept)`` channels.

    Scheme, from the operands: f32 ``w`` is **f32**; int8 ``w`` with
    ``w_scale [O]`` is **W8** (f32 activations, int8 filters), and with a
    calibrated ``x_scale`` too **W8A8** (activations quantized to int8
    here, int32 sums in the kernel, ``x_scale`` folded into the rescale).
    Raises for int8 weights without ``w_scale`` and for ``x_scale`` with f32
    weights.

    Routing, in order: the **1x1 fast path** (:func:`conv_gemm1x1_elected`,
    counted per scheme in :func:`conv_fastpath_counts`) lowers to
    :func:`matmul` / :func:`qmatmul`; the **fallback matrix**
    (:func:`conv_fallback_reason`) routes to the plain version (dequantized
    filters, fake-quantized activations for W8A8), counted in
    :func:`conv_fallback_counts`; everything else runs the implicit-GEMM
    conv kernel."""
    epilogue = tuple(tuple(s) for s in epilogue)
    sides = tuple(epilogue_sides)
    _, c_in, h, w_in = x.shape
    _, _, kh, kw_ = w.shape
    is_q = w.dtype == torch.int8
    if is_q and w_scale is None:
        raise ValueError("int8 conv weights need w_scale")
    if x_scale is not None and not is_q:
        raise ValueError("x_scale (W8A8) requires int8 weights")
    scheme = "f32" if not is_q else ("w8a8" if x_scale is not None else "w8")
    c_live = int(kept.shape[0]) if kept is not None else c_in
    if conv_gemm1x1_elected(kh, kw_, groups, padding, c_live):
        _metrics.registry().counter(_CONV_FASTPATH_METRIC, scheme=scheme).inc()
        return _conv2d_1x1_gemm(
            x, w, bias, stride=stride, kept=kept, w_scale=w_scale, x_scale=x_scale,
            activation=activation, epilogue=epilogue, sides=sides,
        )
    reason = conv_fallback_reason(
        c_live, h, w_in, kh, kw_, stride, padding, groups=groups, dilation=dilation,
    )
    if reason is not None:
        _metrics.registry().counter(_CONV_FALLBACK_METRIC, reason=reason).inc()
        return _conv2d_fallback(
            x, w, bias, stride=stride, padding=padding, kept=kept, w_scale=w_scale,
            x_scale=x_scale, groups=groups, dilation=dilation, activation=activation,
            epilogue=epilogue, sides=sides,
        )
    ws = None
    if is_q:
        ws = w_scale.float()
        if scheme == "w8a8":
            s = scale_tensor(x_scale, x)
            x = quantize_array(x, s)
            ws = ws * s
    return _conv2d_gemm(
        x.contiguous(), w.contiguous(), bias, *(s.contiguous() for s in sides),
        ws=None if ws is None else ws.contiguous(), kept=kept, stride=stride,
        padding=padding, activation=activation, epilogue=epilogue,
    )


# --------------------------------------------------------------------------- #
# fused elementwise                                                            #
# --------------------------------------------------------------------------- #


def fused_elementwise(
    x: torch.Tensor,
    sides: Sequence[torch.Tensor] = (),
    steps: Sequence[Tuple] = (),
    norm_params: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
) -> torch.Tensor:
    """Run a fused elementwise step program over ``x`` in one kernel pass.
    ``x`` has any leading batch dims; steps operate on the flattened
    ``[M, D]`` view (D = last dim, the layer-norm axis); ``sides`` match
    ``x``'s shape exactly; ``norm_params`` is one ``(scale[D], bias[D])``
    pair per ``("norm", slot, eps)`` step."""
    d = x.shape[-1]
    for s in sides:
        if s.shape != x.shape:
            raise ValueError(f"fused_elementwise: side {tuple(s.shape)} != {tuple(x.shape)}")
    x2 = x.reshape(-1, d).contiguous()
    s2 = [s.reshape(-1, d).contiguous() for s in sides]
    y = _fused_elementwise(x2, s2, tuple(tuple(s) for s in steps), tuple(norm_params))
    return y.reshape(x.shape)


# --------------------------------------------------------------------------- #
# decoder: gated FFN and attention                                             #
# --------------------------------------------------------------------------- #


def ffn_gateup(
    x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, *, activation: str = "silu"
) -> torch.Tensor:
    """Fused ``act(x @ w_gate) * (x @ w_up)`` for arbitrary leading batch dims
    (no padding: the kernel masks ragged edges)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = _ffn_mod.ffn_gateup(
        x2, w_gate.contiguous(), w_up.contiguous(), activation=activation
    )
    return out.reshape(*lead, w_gate.shape[1])


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lengths: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention over ``q [B, H, Sq, d]`` and ``k / v [B, G, Skv, d]``
    (``G`` divides ``H``; ``G == H`` is plain multi-head attention).
    ``kv_lengths [B]`` masks each row to its valid KV prefix -- the paged-KV
    path, where Skv is the gathered page span, not the live length.  Unlike
    the JAX wrapper nothing is padded to block multiples (the kernel masks
    ragged edges), so non-causal attention without lengths takes any
    shape.  The result on every row equals the JAX wrapper's on its valid
    rows."""
    return _flash_mod.flash_attention(q, k, v, kv_lengths, causal=causal, scale=scale)
