"""Plain PyTorch versions of the kernels (the correctness contract).

A port of ``repro.kernels.ref`` for the slice's kernels: each ``*_ref``
takes the same logical arguments as its kernel wrapper and computes the
answer with plain torch ops at f32.  On a CPU tensor the wrappers run these;
on the card ``chip_smoke.py`` holds each CUDA kernel against them.

Semantics follow the JAX package exactly where torch's defaults differ:
``gelu`` is the tanh approximation (``jax.nn.gelu``'s default), variances
are population variances (``correction=0``), and ``conv2d_ref`` pads the way
XLA does (SAME splits the total pad with the smaller half on the low side;
explicit pad pairs, negative ones included, pass through).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "ACTIVATIONS",
    "apply_steps_ref",
    "fused_elementwise_ref",
    "matmul_ref",
    "conv2d_ref",
    "xla_conv_pads",
]

_ACT = {
    None: lambda x: x,
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
}
#: the activation names every kernel accepts, in their opcode order
#: (``kernels/csrc/epilogue.cuh`` numbers them 0..4 the same way)
ACTIVATIONS: Tuple[Optional[str], ...] = tuple(_ACT)


def apply_steps_ref(y, steps, sides=(), norm_params=()):
    """Run a kernel-local step program with plain torch ops: the oracle of
    the fused kernels *and* the executor's step interpreter.
    ``("add"|"mul", slot)`` indexes ``sides``; ``("norm", slot, eps)``
    (layer norm over the last dim) and ``("norm_instance", slot, eps)``
    (per-(N, C) over NCHW spatial dims) index ``norm_params``, a sequence of
    (scale, bias) pairs."""
    for step in steps:
        kind = step[0]
        if kind == "activation":
            y = _ACT[step[1]](y)
        elif kind == "add":
            y = y + sides[step[1]]
        elif kind == "mul":
            y = y * sides[step[1]]
        elif kind in ("norm", "norm_instance"):
            scale, bias = norm_params[step[1]]
            dims = (-1,) if kind == "norm" else (2, 3)
            mu = y.mean(dim=dims, keepdim=True)
            var = y.var(dim=dims, keepdim=True, correction=0)
            if kind == "norm_instance":
                scale = scale[None, :, None, None]
                bias = bias[None, :, None, None]
            y = (y - mu) / torch.sqrt(var + step[2]) * scale + bias
        else:
            raise NotImplementedError(f"step {kind}")
    return y


def fused_elementwise_ref(x, sides, steps, norm_params=(), *, out_dtype=None):
    """f32 plain version of the fused elementwise kernel."""
    y = apply_steps_ref(
        x.float(),
        steps,
        [s.float() for s in sides],
        [(s.float(), b.float()) for s, b in norm_params],
    )
    return y.to(out_dtype or x.dtype)


def matmul_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    activation: Optional[str] = None,
    out_dtype=None,
) -> torch.Tensor:
    acc = x.float() @ w.float()
    if bias is not None:
        acc = acc + bias.float()
    return _ACT[activation](acc).to(out_dtype or x.dtype)


def xla_conv_pads(h: int, k: int, stride: int, padding, axis: int) -> Tuple[int, int]:
    """(low, high) pad of one spatial axis under XLA conv semantics; ``k`` is
    the (dilated) filter extent, ``axis`` 0 or 1 picks an explicit pair."""
    if isinstance(padding, str):
        if padding == "VALID":
            return 0, 0
        if padding != "SAME":
            raise ValueError(f"unsupported padding {padding!r} (SAME, VALID, or pad pairs)")
        out = -(-h // stride)
        total = max((out - 1) * stride + k - h, 0)
        return total // 2, total - total // 2
    lo, hi = padding[axis]
    return int(lo), int(hi)


def conv2d_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding="SAME",
    groups: int = 1,
    dilation: int = 1,
    activation: Optional[str] = None,
    out_dtype=None,
) -> torch.Tensor:
    """f32 plain conv: ``x [N, C, H, W]`` NCHW, ``w [O, C/groups, kh, kw]``
    OIHW, XLA padding semantics.  Written as the GEMM the kernel computes --
    an explicit ``F.pad``, the im2col matrix from ``F.unfold``, one f32
    matmul per group -- so it never takes a library convolution (which
    convolves f32 in TF32 on the card by default)."""
    n, _, h, wd = x.shape
    o, cg, kh, kw = w.shape
    ekh, ekw = (kh - 1) * dilation + 1, (kw - 1) * dilation + 1
    ph = xla_conv_pads(h, ekh, stride, padding, 0)
    pw = xla_conv_pads(wd, ekw, stride, padding, 1)
    xp = F.pad(x.float(), (pw[0], pw[1], ph[0], ph[1]))
    oh = max((xp.shape[2] - ekh) // stride + 1, 0)
    ow = max((xp.shape[3] - ekw) // stride + 1, 0)
    if cg == 0 or oh == 0 or ow == 0:  # an empty contraction (or output)
        y = torch.zeros((n, o, oh, ow), dtype=torch.float32, device=x.device)
    else:
        cols = F.unfold(xp, (kh, kw), dilation=dilation, stride=stride)
        cols = cols.reshape(n, groups, cg * kh * kw, oh * ow)
        wm = w.float().reshape(groups, o // groups, cg * kh * kw)
        y = torch.matmul(wm, cols).reshape(n, o, oh, ow)
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    return _ACT[activation](y).to(out_dtype or x.dtype)
