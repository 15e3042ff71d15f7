"""Implicit-GEMM conv2d with a fused epilogue: CUDA kernel + plain version.

Replaces the TPU kernel ``repro/kernels/conv2d.py:conv2d_gemm_kernel``
(wrapper ``conv2d_gemm``) for the f32 and channel-pruned schemes.
``conv2d_gemm(x, w, bias, *sides, kept=..., stride=..., padding=...)``
computes ``epilogue(act(conv(x[:, kept], w) + bias))`` with ``x [N, C, H, W]``
NCHW, ``w [O, C', kh, kw]`` OIHW (``C' = len(kept)`` for a channel-pruned
conv) and sides ``[N, O, OH, OW]``.

The TPU wrapper made a zero-padded NHWC copy of the input in device memory
and gathered ``kept`` channels in XLA before its kernel; the CUDA kernel
(``csrc/conv2d.cu``) works from the public layout instead: it reads NCHW in
place, turns the zero border into bounds checks (XLA's SAME split, see
:func:`conv_pad_hw`), gathers the live channels by index inside the kernel,
builds each im2col slab in shared memory only, and writes NCHW.

What bounds it on an H100: the demo apps' 3x3 / 7x7 layers contract
K = 147..1728 per output element, so f32 FMA throughput on the CUDA cores
bounds them (no TF32: the plan tolerances assume true f32); the tile shape
follows the output-channel count so narrow heads waste little of a tile.
Routing: a CPU tensor takes :func:`conv2d_plain`, a CUDA tensor launches the
kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .dense_matmul import validate_epilogue
from .ref import _ACT, apply_steps_ref, conv2d_ref

__all__ = [
    "conv2d_gemm",
    "conv2d_plain",
    "conv_out_hw",
    "conv_pad_hw",
    "conv_padding_token",
]

#: kernel launches made by :func:`conv2d_gemm` (CUDA route only)
launches = 0


def _explicit_pads(padding) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Normalize lax-style explicit padding ``((ph_lo, ph_hi), (pw_lo, pw_hi))``."""
    (a, b), (c, d) = padding
    return (int(a), int(b)), (int(c), int(d))


def conv_out_hw(h: int, w: int, kh: int, kw: int, stride: int, padding) -> Tuple[int, int]:
    """Output spatial dims of a stride-``stride`` conv: ``"SAME"``,
    ``"VALID"``, or lax-style explicit pad pairs."""
    if isinstance(padding, str):
        if padding == "SAME":
            return -(-h // stride), -(-w // stride)
        if padding == "VALID":
            return (h - kh) // stride + 1, (w - kw) // stride + 1
        raise ValueError(f"unsupported padding {padding!r} (SAME, VALID, or pad pairs)")
    (a, b), (c, d) = _explicit_pads(padding)
    return (h + a + b - kh) // stride + 1, (w + c + d - kw) // stride + 1


def conv_pad_hw(h: int, w: int, kh: int, kw: int, stride: int, padding) -> Tuple[int, int]:
    """(top, left) zero padding of the conv (XLA SAME semantics: the total
    pad is split with the smaller half on the low side -- a 3x3 stride-2
    conv on an even input pads (0, 1), not PyTorch's (1, 1); explicit pairs
    pass through).  The bottom/right pad is implied by the output size."""
    if not isinstance(padding, str):
        (a, _), (c, _) = _explicit_pads(padding)
        return a, c
    if padding == "VALID":
        return 0, 0
    oh, ow = conv_out_hw(h, w, kh, kw, stride, padding)
    ph = max((oh - 1) * stride + kh - h, 0)
    pw = max((ow - 1) * stride + kw - w, 0)
    return ph // 2, pw // 2


def conv_padding_token(padding) -> str:
    """Key suffix distinguishing padding geometries (SAME -- the canonical
    case -- stays suffix-free; VALID and explicit pairs alias neither it nor
    each other)."""
    if isinstance(padding, str):
        return "" if padding == "SAME" else f"+{padding.lower()}"
    (a, b), (c, d) = _explicit_pads(padding)
    return f"+p{a}.{b}.{c}.{d}"


def conv2d_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *sides: torch.Tensor,
    kept: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding="SAME",
    activation: Optional[str] = None,
    epilogue: Tuple[Tuple, ...] = (),
) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments)."""
    if kept is not None:
        x = x.index_select(1, kept)
    y = conv2d_ref(x, w, bias, stride=stride, padding=padding, activation=activation,
                   out_dtype=torch.float32)
    return apply_steps_ref(y, epilogue, [s.float() for s in sides]).to(x.dtype)


def conv2d_gemm(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *sides: torch.Tensor,
    kept: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding="SAME",
    activation: Optional[str] = None,
    epilogue: Tuple[Tuple, ...] = (),
) -> torch.Tensor:
    """``epilogue(act(conv(x[:, kept], w) + bias))``; see the module doc.
    Takes what the kernel takes: ungrouped, undilated, non-negative padding,
    at least one output pixel (``ops.conv2d`` routes the rest to the plain
    version)."""
    global launches
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv2d_gemm: x{tuple(x.shape)} / w{tuple(w.shape)} must be 4-D")
    nb, c_in, h, wd = x.shape
    o, c, kh, kw = w.shape
    if kept is None and c != c_in:
        raise ValueError(f"conv2d_gemm: w has {c} input channels, x has {c_in}")
    if kept is not None and tuple(kept.shape) != (c,):
        raise ValueError(f"conv2d_gemm: kept {tuple(kept.shape)} != ({c},)")
    if stride < 1:
        raise ValueError(f"conv2d_gemm: stride {stride}")
    if not isinstance(padding, str) and min(min(p) for p in _explicit_pads(padding)) < 0:
        raise ValueError(f"conv2d_gemm: negative padding {padding}")
    oh, ow = conv_out_hw(h, wd, kh, kw, stride, padding)
    if oh < 1 or ow < 1:
        raise ValueError(f"conv2d_gemm: empty output {(oh, ow)}")
    if bias is not None and tuple(bias.shape) != (o,):
        raise ValueError(f"conv2d_gemm: bias {tuple(bias.shape)} != ({o},)")
    for s in sides:
        if tuple(s.shape) != (nb, o, oh, ow):
            raise ValueError(f"conv2d_gemm: side {tuple(s.shape)} != {(nb, o, oh, ow)}")
    if activation not in _ACT:
        raise ValueError(f"unknown activation {activation!r}")
    epilogue = tuple(tuple(s) for s in epilogue)
    validate_epilogue(epilogue, len(sides))
    named = {f"side{i}": s for i, s in enumerate(sides)}
    dev = _build.kernel_device("conv2d_gemm", x=x, w=w, bias=bias, kept=kept, **named)
    if dev.type == "cpu":
        return conv2d_plain(x, w, bias, *sides, kept=kept, stride=stride, padding=padding,
                            activation=activation, epilogue=epilogue)
    pt, pl = conv_pad_hw(h, wd, kh, kw, stride, padding)
    out = torch.empty((nb, o, oh, ow), dtype=torch.float32, device=dev)
    prog = _build.encode_program(epilogue)
    side_ptrs = _build.pointer_array(sides)
    lib = _build.lib()
    err = lib.repro_conv2d(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        None if kept is None else kept.data_ptr(), out.data_ptr(),
        nb, c_in, h, wd, c, o, kh, kw, stride, pt, pl, oh, ow,
        _build.activation_code(activation),
        prog["n"], _build.addr(prog["prog"]), len(sides), _build.addr(side_ptrs),
        _build.stream_handle(),
    )
    _build.check(err, "conv2d_gemm")
    launches += 1
    return out
