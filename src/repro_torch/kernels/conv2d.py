"""Implicit-GEMM conv2d with a fused epilogue: CUDA kernel + plain version.

Replaces the TPU kernel ``repro/kernels/conv2d.py:conv2d_gemm_kernel``
(wrapper ``conv2d_gemm``) in every scheme: f32, channel-pruned, and the
INT8 schemes W8 and W8A8.
``conv2d_gemm(x, w, bias, *sides, ws=..., kept=..., stride=..., padding=...)``
computes ``epilogue(act(conv(x[:, kept], w) * ws + bias))`` with
``x [N, C, H, W]`` NCHW, ``w [O, C', kh, kw]`` OIHW (``C' = len(kept)`` for
a channel-pruned conv) and sides ``[N, O, OH, OW]``.  The operand types
pick the scheme: f32 ``x`` and ``w`` is f32 (no ``ws``); f32 ``x`` with
int8 ``w`` is W8; int8 ``x`` and ``w`` is W8A8.  The INT8 schemes need
``ws [O]``, the combined per-output-channel rescale (``w_scale``, times the
activation scale for W8A8: the caller quantizes W8A8 activations, as the
TPU wrapper does, and folds their scale in).

The TPU wrapper made a zero-padded NHWC copy of the input in device memory
and gathered ``kept`` channels in XLA before its kernel; the CUDA kernel
(``csrc/conv2d.cu``) works from the public layout instead: it reads NCHW in
place, turns the zero border into bounds checks (XLA's SAME split, see
:func:`conv_pad_hw`), gathers the live channels by index inside the kernel,
builds each im2col slab in shared memory only, and writes NCHW.

What bounds it on an H100: the demo apps' 3x3 / 7x7 layers contract
K = 147..1728 per output element, so multiply-add throughput on the CUDA
cores bounds them (true f32, no TF32: the plan tolerances assume it; exact
int32 for W8A8); the tile is one of ``_build.CONV_TILES`` (``ops.conv2d``
resolves it through the tuning cache), by default chosen by the
output-channel count so narrow heads waste little of a tile.  The f32 and
W8 body spends its issue slots on FMAs: 8 x 8 register micro-tiles read
from shared memory as float4, double-buffered slabs with the next slab's
gather in flight (4-byte ``cp.async``, zero-fill for the border), per-CTA
and per-slab offset tables instead of per-element division, 32-bit
offsets (an operand of 2^31 elements or more raises).  Each output sums K
in ascending order in one FMA chain, so every tile is bit-equal to every
other.  W8 widens its int8 filter as it stages it.  W8A8 has its own body on
int8 tensor cores (``mma.sync`` m16n8k32 s8 on int8 patch and filter
slabs, the patch gather of the next slab through registers, the filter by
16-byte ``cp.async`` where ``K % 16 == 0``; exact int32 sums, so it gives
the plain version's bits).

The plain version accumulates the INT8 schemes in float64 -- exact for
W8A8, whose integer sums pass 2^24 (127^2 x 1728 = 2.8e7) where a float32
sum is not -- then rescales in f32 like the kernel.  Routing: a CPU tensor
takes :func:`conv2d_plain`, a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches, ``scheme_launches`` splits them by
scheme.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from .dense_matmul import validate_epilogue
from .ref import _ACT, apply_steps_ref, conv2d_ref

__all__ = [
    "conv2d_gemm",
    "conv2d_plain",
    "conv_scheme",
    "conv_out_hw",
    "conv_pad_hw",
    "conv_padding_token",
]

#: kernel launches made by :func:`conv2d_gemm` (CUDA route only)
launches = 0
#: the same launches by scheme
scheme_launches = {scheme: 0 for scheme in _build.SCHEME_CODES}


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


def conv_scheme(x_dtype: torch.dtype, w_dtype: torch.dtype) -> str:
    """The kernel scheme of a conv's operand types (see the module doc)."""
    if w_dtype == torch.int8:
        return "w8a8" if x_dtype == torch.int8 else "w8"
    return "f32"


def check_extents(scheme: str, x_shape, w_shape, out_shape) -> None:
    """Raise, naming the shapes, where the kernel cannot take a conv: the
    f32 / W8 body indexes its operands with 32-bit offsets, so each of x, w
    and the output must hold fewer than 2^31 elements, and it splits k by a
    32-bit multiply-high, so K * kh * kw must stay under 2^32 (W8A8 indexes
    in 64 bits)."""
    if scheme == "w8a8":
        return
    k_khw = int(np.prod(w_shape[1:])) * int(w_shape[2]) * int(w_shape[3])
    if max(int(np.prod(s)) for s in (x_shape, w_shape, out_shape)) >= 2 ** 31 or k_khw >= 2 ** 32:
        raise ValueError(f"conv2d_gemm: x{tuple(x_shape)} w{tuple(w_shape)} -> "
                         f"{tuple(out_shape)}: the {scheme} kernel takes operands of fewer "
                         f"than 2^31 elements")


def conv2d_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *sides: torch.Tensor,
    ws: Optional[torch.Tensor] = None,
    kept: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding="SAME",
    activation: Optional[str] = None,
    epilogue: Tuple[Tuple, ...] = (),
) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments)."""
    if kept is not None:
        x = x.index_select(1, kept)
    if w.dtype == torch.int8:
        acc = conv2d_ref(x, w, stride=stride, padding=padding, acc_dtype=torch.float64,
                         out_dtype=torch.float32)
        y = acc * ws.float()[None, :, None, None]
        if bias is not None:
            y = y + bias.float()[None, :, None, None]
        y = _ACT[activation](y)
    else:
        y = conv2d_ref(x, w, bias, stride=stride, padding=padding, activation=activation,
                       out_dtype=torch.float32)
    return apply_steps_ref(y, epilogue, [s.float() for s in sides])


def conv2d_gemm(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *sides: torch.Tensor,
    ws: Optional[torch.Tensor] = None,
    kept: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding="SAME",
    activation: Optional[str] = None,
    epilogue: Tuple[Tuple, ...] = (),
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """``epilogue(act(conv(x[:, kept], w) * ws + bias))``; see the module
    doc.  Takes what the kernel takes: ungrouped, undilated, non-negative
    padding, at least one output pixel (``ops.conv2d`` routes the rest to
    the plain version).  The tile ``(block_m, block_n, block_k)`` -- output
    pixels x output channels x K slab -- must be one of
    ``_build.CONV_TILES`` (else ``_build.TileError``); sizes left as
    ``None`` come from the default tile for the scheme and ``O``."""
    global launches
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv2d_gemm: x{tuple(x.shape)} / w{tuple(w.shape)} must be 4-D")
    if x.dtype == torch.int8 and w.dtype != torch.int8:
        raise TypeError("conv2d_gemm: int8 activations need int8 weights (W8A8)")
    scheme = conv_scheme(x.dtype, w.dtype)
    if (scheme == "f32") != (ws is None):
        raise ValueError(f"conv2d_gemm: the {scheme} scheme "
                         f"{'takes no' if scheme == 'f32' else 'needs a'} ws rescale")
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
    if ws is not None and tuple(ws.shape) != (o,):
        raise ValueError(f"conv2d_gemm: ws {tuple(ws.shape)} != ({o},)")
    for s in sides:
        if tuple(s.shape) != (nb, o, oh, ow):
            raise ValueError(f"conv2d_gemm: side {tuple(s.shape)} != {(nb, o, oh, ow)}")
    if activation not in _ACT:
        raise ValueError(f"unknown activation {activation!r}")
    epilogue = tuple(tuple(s) for s in epilogue)
    validate_epilogue(epilogue, len(sides))
    dm, dn, dk = _build.conv_default_tile(scheme, o)
    tile = _build.check_conv_tile((block_m or dm, block_n or dn, block_k or dk), "conv2d_gemm")
    named = {f"side{i}": s for i, s in enumerate(sides)}
    int8 = {"w8": ("w",), "w8a8": ("x", "w")}.get(scheme, ())
    dev = _build.kernel_device(
        "conv2d_gemm", {k: torch.int8 for k in int8},
        x=x, w=w, ws=ws, bias=bias, kept=kept, **named,
    )
    if dev.type == "cpu":
        return conv2d_plain(x, w, bias, *sides, ws=ws, kept=kept, stride=stride,
                            padding=padding, activation=activation, epilogue=epilogue)
    check_extents(scheme, tuple(x.shape), tuple(w.shape), (nb, o, oh, ow))
    pt, pl = conv_pad_hw(h, wd, kh, kw, stride, padding)
    out = torch.empty((nb, o, oh, ow), dtype=torch.float32, device=dev)
    prog = _build.encode_program(epilogue)
    side_ptrs = _build.pointer_array(sides)
    lib = _build.lib()
    err = lib.repro_conv2d(
        x.data_ptr(), w.data_ptr(), None if ws is None else ws.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if kept is None else kept.data_ptr(), out.data_ptr(),
        nb, c_in, h, wd, c, o, kh, kw, stride, pt, pl, oh, ow,
        _build.activation_code(activation), _build.SCHEME_CODES[scheme],
        prog["n"], _build.addr(prog["prog"]), len(sides), _build.addr(side_ptrs), *tile,
        _build.stream_handle(),
    )
    _build.check(err, "conv2d_gemm")
    launches += 1
    scheme_launches[scheme] += 1
    return out
