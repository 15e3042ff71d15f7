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

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..quant.qtensor import fake_quant

__all__ = [
    "ACTIVATIONS",
    "apply_steps_ref",
    "fused_elementwise_ref",
    "matmul_ref",
    "qmatmul_ref",
    "conv2d_ref",
    "qconv2d_ref",
    "pbcsr_to_dense_ref",
    "bsr_matmul_ref",
    "xla_conv_pads",
    "ffn_gateup_ref",
    "rope_ref",
    "flash_attention_ref",
    "bf16_ulp",
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
        elif kind == "norm_rms":
            scale, _ = norm_params[step[1]]
            yf = y.float()
            var = (yf * yf).mean(dim=-1, keepdim=True)
            y = (yf * torch.rsqrt(var + step[2])).to(y.dtype) * scale
        elif kind == "rope":
            y = rope_ref(y, sides[step[1]], step[2], step[3])
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
    acc_dtype=torch.float32,
) -> torch.Tensor:
    """``act(x @ w + bias)`` with operands cast to ``acc_dtype`` (float64
    makes an int8 x int8 product exact: its sums stay far below 2^53)."""
    acc = x.to(acc_dtype) @ w.to(acc_dtype)
    if bias is not None:
        acc = acc + bias.to(acc_dtype)
    return _ACT[activation](acc).to(out_dtype or x.dtype)



def pbcsr_to_dense_ref(
    values: torch.Tensor, block_rows: torch.Tensor, k: int
) -> torch.Tensor:
    """Rebuild the dense [K, N] weight from packed blocks ``values [Nb, S,
    bm, bn]`` and ``block_rows [Nb, S]`` (-1 = pad): each packed slot is
    added into its block-row (pads add zeros at row 0), as the JAX
    reference does."""
    nb, s, bm, bn = values.shape
    kb = k // bm
    dense = values.new_zeros((kb, nb, bm, bn))
    rows = block_rows.clamp(min=0).long()
    valid = (block_rows >= 0)[..., None, None]
    cols = torch.arange(nb, device=values.device)
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    for si in range(s):
        dense.index_put_((rows[:, si], cols), torch.where(valid[:, si], values[:, si], zero),
                         accumulate=True)
    return dense.permute(0, 2, 1, 3).reshape(kb * bm, nb * bn)


def bsr_matmul_ref(
    x: torch.Tensor,
    values: torch.Tensor,
    block_rows: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    activation: Optional[str] = None,
    out_dtype=None,
) -> torch.Tensor:
    """``act(x @ W + bias)`` over PBCSR-packed ``W`` (dense rebuild, f32 sum)."""
    w = pbcsr_to_dense_ref(values, block_rows, x.shape[-1])
    return matmul_ref(x, w, bias, activation=activation, out_dtype=out_dtype or x.dtype)


def qmatmul_ref(
    x: torch.Tensor,
    w_q: torch.Tensor,
    w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    x_scale: Optional[float] = None,
    activation: Optional[str] = None,
    out_dtype=None,
) -> torch.Tensor:
    """f32 oracle for the quantized matmul (both schemes).

    ``x`` is always the *float* activation; ``x_scale`` (the calibrated
    static activation scale) selects W8A8 -- the activation is fake-quantized
    with the same round/clip the kernel path applies, so
    ``(q_x * sx) @ (q_w * sw)`` reproduces the kernel's
    ``(q_x @ q_w) * sx * sw`` up to f32 rounding.  Without ``x_scale`` this
    is the W8-only path: full-precision activations against the dequantized
    int8 weight.
    """
    w = w_q.float() * w_scale.float()[None, :]
    xf = x.float()
    if x_scale is not None:
        xf = fake_quant(xf, x_scale)
    return matmul_ref(xf, w, bias, activation=activation, out_dtype=out_dtype or torch.float32)


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
    acc_dtype=torch.float32,
) -> torch.Tensor:
    """Plain conv: ``x [N, C, H, W]`` NCHW, ``w [O, C/groups, kh, kw]``
    OIHW, XLA padding semantics.  Written as the GEMM the kernel computes --
    an explicit ``F.pad``, the im2col matrix from ``F.unfold``, one matmul
    per group in ``acc_dtype`` (f32 by default; float64 makes an int8 x
    int8 conv exact) -- so it never takes a library convolution (which
    convolves f32 in TF32 on the card by default)."""
    n, _, h, wd = x.shape
    o, cg, kh, kw = w.shape
    ekh, ekw = (kh - 1) * dilation + 1, (kw - 1) * dilation + 1
    ph = xla_conv_pads(h, ekh, stride, padding, 0)
    pw = xla_conv_pads(wd, ekw, stride, padding, 1)
    xp = F.pad(x.to(acc_dtype), (pw[0], pw[1], ph[0], ph[1]))
    oh = max((xp.shape[2] - ekh) // stride + 1, 0)
    ow = max((xp.shape[3] - ekw) // stride + 1, 0)
    if cg == 0 or oh == 0 or ow == 0:  # an empty contraction (or output)
        y = torch.zeros((n, o, oh, ow), dtype=acc_dtype, device=x.device)
    else:
        cols = F.unfold(xp, (kh, kw), dilation=dilation, stride=stride)
        cols = cols.reshape(n, groups, cg * kh * kw, oh * ow)
        wm = w.to(acc_dtype).reshape(groups, o // groups, cg * kh * kw)
        y = torch.matmul(wm, cols).reshape(n, o, oh, ow)
    if bias is not None:
        y = y + bias.to(acc_dtype)[None, :, None, None]
    return _ACT[activation](y).to(out_dtype or x.dtype)


def qconv2d_ref(
    x: torch.Tensor,
    w_q: torch.Tensor,
    w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    x_scale: Optional[float] = None,
    stride: int = 1,
    padding="SAME",
    groups: int = 1,
    dilation: int = 1,
    activation: Optional[str] = None,
    out_dtype=None,
) -> torch.Tensor:
    """f32 oracle for the quantized conv (both schemes), mirroring
    :func:`qmatmul_ref`: ``w_q [O, C, kh, kw]`` int8 with per-output-channel
    ``w_scale [O]``; ``x_scale`` selects W8A8 (activations fake-quantized
    with the kernel path's round/clip), else W8-only (f32 activations
    against the dequantized weight)."""
    w = w_q.float() * w_scale.float()[:, None, None, None]
    xf = x.float()
    if x_scale is not None:
        xf = fake_quant(xf, x_scale)
    return conv2d_ref(
        xf, w, bias, stride=stride, padding=padding, groups=groups,
        dilation=dilation, activation=activation, out_dtype=out_dtype or torch.float32,
    )


def ffn_gateup_ref(
    x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, *, activation: str = "silu"
) -> torch.Tensor:
    """``act(x @ w_gate) * (x @ w_up)`` at f32, cast to ``x``'s type."""
    xf = x.float()
    g = _ACT[activation](xf @ w_gate.float())
    u = xf @ w_up.float()
    return (g * u).to(x.dtype)


def rope_ref(
    x: torch.Tensor, positions: torch.Tensor, heads: int, theta: float = 10000.0
) -> torch.Tensor:
    """Split-half RoPE over a flattened head axis: ``x [..., S, heads*dh]``,
    ``positions [..., S]`` ints; f32 compute, cast back (``models.layers.
    apply_rope`` on the unflattened heads)."""
    *lead, s, hd = x.shape
    dh = hd // heads
    xh = x.reshape(*lead, s, heads, dh).float()
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh))
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = xh[..., : dh // 2], xh[..., dh // 2 :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype).reshape(*lead, s, hd)


def bf16_ulp(x: float) -> float:
    """One bf16 unit in the last place (8 significant bits) at magnitude
    ``x``: the tolerance unit of a bf16 result whose f32 value was rounded
    once."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


#: the masked-score value of the attention kernels (a finite stand-in for
#: -inf: a row whose every key is masked averages V uniformly, never NaN)
NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lengths: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    scale=None,
) -> torch.Tensor:
    """Naive softmax attention at f32: ``q/k/v [B, H, S, d]``; ``causal``
    keeps ``col <= row`` (top-left aligned), ``kv_lengths [B]`` keeps
    ``col < length``; masked scores are ``-1e30``.  Output in ``q``'s
    type."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    sq, skv = s.shape[-2:]
    if causal:
        mask = torch.arange(skv, device=q.device)[None, :] <= torch.arange(sq, device=q.device)[:, None]
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    if kv_lengths is not None:
        valid = torch.arange(skv, device=q.device)[None, :] < kv_lengths.to(q.device)[:, None]
        s = torch.where(valid[:, None, None, :], s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
