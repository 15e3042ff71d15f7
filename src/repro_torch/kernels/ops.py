"""Public wrappers around the port's kernels (a port of ``repro.kernels.ops``
for the slice's paths).

These do the layout work so the executor calls one function per op:
leading-batch flattening, the 1x1-conv direct-GEMM fast path, and the conv
fallback matrix.  Each routes to a kernel wrapper in this package, whose
device picks the route (CPU tensor: plain version; CUDA tensor: the CUDA
kernel or an error).

Differences from the JAX wrappers, by design:

* no padding to block multiples -- the CUDA kernels mask ragged edges;
* no block-size tuning cache -- the kernels pick fixed tiles for the card
  (the cache comes with the port of ``launch/tune``);
* the conv fallback matrix keeps ``groups`` / ``dilation`` / ``padding`` /
  ``degenerate`` and routes them to the plain version (never to a library
  convolution), counted in ``conv_fallback_total{reason}`` as the JAX
  package counts its ``lax.conv`` route.  Its TPU-only ``vmem`` reason is
  gone: the CUDA kernel tiles its own shared memory at any width.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..obs import metrics as _metrics
from . import conv2d as _conv2d_mod
from . import dense_matmul as _dense_mod
from . import fused_elementwise as _fused_mod
from .conv2d import conv2d_gemm as _conv2d_gemm
from .conv2d import conv_out_hw, conv_pad_hw, conv_padding_token
from .dense_matmul import dense_matmul as _dense_matmul
from .fused_elementwise import fused_elementwise as _fused_elementwise
from .ref import apply_steps_ref, conv2d_ref

__all__ = [
    "matmul",
    "col_matmul",
    "conv2d",
    "fused_elementwise",
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
    "reset_kernel_launches",
]

#: kernel modules by the name their launch count is reported under
_KERNEL_MODULES = {
    "conv2d": _conv2d_mod,
    "dense_matmul": _dense_mod,
    "fused_elementwise": _fused_mod,
}


def kernel_launch_counts() -> Dict[str, int]:
    """CUDA kernel launches per kernel since the last reset (CPU calls that
    take the plain versions launch nothing and count nothing)."""
    return {name: mod.launches for name, mod in _KERNEL_MODULES.items()}


def reset_kernel_launches() -> None:
    for mod in _KERNEL_MODULES.values():
        mod.launches = 0


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


def _conv2d_fallback(x, w, bias, *, stride, padding, kept, groups, dilation,
                     activation, epilogue, sides):
    """The plain route for configs outside the kernel's matrix -- the same
    math as the reference handler (channel gather, conv, step tail)."""
    if kept is not None:
        x = x.index_select(1, kept)
    y = conv2d_ref(x, w, bias, stride=stride, padding=padding, groups=groups,
                   dilation=dilation, activation=activation, out_dtype=torch.float32)
    if epilogue:
        y = apply_steps_ref(y, epilogue, [s.float() for s in sides])
    return y.to(x.dtype)


def _conv2d_1x1_gemm(x, w, bias, *, stride, kept, activation, epilogue, sides):
    """The 1x1 direct-GEMM fast path: a unit-tap conv with no border padding
    is ``y[n, :, i, j] = W @ x[n, :, i*s, j*s]`` -- a plain GEMM over the
    ``N*OH*OW`` pixel axis.  NCHW is permuted to pixel-major ``[P, C]`` (the
    stride subsamples the grid first), the OIHW filter collapses to
    ``[C, O]``, and bias / activation / epilogue with its side operands ride
    the dense-matmul kernel.  The permutes around it are plain torch."""
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

    Routing, in order: the **1x1 fast path** (:func:`conv_gemm1x1_elected`,
    counted per scheme in :func:`conv_fastpath_counts`) lowers to
    :func:`matmul`; the **fallback matrix**
    (:func:`conv_fallback_reason`) routes to the plain version, counted in
    :func:`conv_fallback_counts`; everything else runs the implicit-GEMM
    conv kernel."""
    epilogue = tuple(tuple(s) for s in epilogue)
    sides = tuple(epilogue_sides)
    _, c_in, h, w_in = x.shape
    _, _, kh, kw_ = w.shape
    c_live = int(kept.shape[0]) if kept is not None else c_in
    if conv_gemm1x1_elected(kh, kw_, groups, padding, c_live):
        _metrics.registry().counter(_CONV_FASTPATH_METRIC, scheme="f32").inc()
        return _conv2d_1x1_gemm(
            x, w, bias, stride=stride, kept=kept, activation=activation,
            epilogue=epilogue, sides=sides,
        )
    reason = conv_fallback_reason(
        c_live, h, w_in, kh, kw_, stride, padding, groups=groups, dilation=dilation,
    )
    if reason is not None:
        _metrics.registry().counter(_CONV_FALLBACK_METRIC, reason=reason).inc()
        return _conv2d_fallback(
            x, w, bias, stride=stride, padding=padding, kept=kept, groups=groups,
            dilation=dilation, activation=activation, epilogue=epilogue, sides=sides,
        )
    return _conv2d_gemm(
        x.contiguous(), w.contiguous(), bias, *(s.contiguous() for s in sides),
        kept=kept, stride=stride, padding=padding, activation=activation,
        epilogue=epilogue,
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
