"""Dense matmul (f32 or bf16) with a fused epilogue program: CUDA kernel +
plain version.

Replaces the TPU kernel ``repro/kernels/dense_matmul.py:dense_matmul_kernel``
(wrapper ``dense_matmul``).  ``dense_matmul(x, w, bias, *sides)`` computes
``epilogue(act(x @ w + bias))`` for 2-D ``x [M, K]`` / ``w [K, N]``; the
epilogue is a step program (``("activation", fn)`` / ``("add"|"mul", slot)``
over ``sides``, each ``[M, N]``) run on the f32 accumulator before the one
store.  Operands share one element type, f32 or bf16 (x, w, bias and the
sides); the accumulator and epilogue are f32 and the output takes x's type,
as the TPU kernel's ``preferred_element_type=f32`` and ``astype`` do.
Kernels (``csrc/dense_matmul.cu``), each masking ragged M / N / K itself,
so nothing is padded in device memory (the TPU wrapper pads to
128-blocks):

* f32: the CUDA-core body of ``csrc/simt_gemm.cuh`` (8 x 8 / 8 x 4
  register micro-tiles, cp.async slabs, FMA in true f32) with a tile
  ``(block_m, block_n, block_k)`` of ``_build.GEMM_TILES`` at depth 1, in
  the row-major layout or, for the 1x1-conv path (``_layout="nchw"``),
  reading ``x [nb, K, OH, OW]`` and writing ``out [nb, N, OH, OW]`` where
  they lie, with ``w [N, K]`` (the OIHW filter's view);
* bf16 where TMA addresses the operands (``_build.bf16_body``: x, w and
  out 16-byte aligned, K and N multiples of 8): the Hopper kernel
  (``csrc/wgmma_gemm.cuh``: TMA into a ring of swizzled slots, ``wgmma``
  m64nBNk16, f32 accumulators) with a tile of ``_build.BF16_GEMM_TILES`` at
  depth 1, its K split into at most 8 ranges ``_build.tma_plan`` fixes from
  the shape, summed in a thread block cluster (no workspace); at most 8
  rows with no tile named only for N <= ``_build.TMA_DECODE_MAX_N`` (the
  decoders' k / v projections at decode), on ``_build.TMA_DECODE_TILE``
  and ``_build.tma_plan``'s ranges, rows past M being TMA's zero fill;
* any other bf16 launch (odd K or N, unaligned pointers): the ``mma.sync``
  kernel (``csrc/mma_gemm.cuh``: cp.async ring, ``ldmatrix`` + ``mma.sync``
  m16n8k16, f32 accumulators) with the same tile, its K split into the
  ranges ``_build.gemm_split`` fixes from the shape (an f32 workspace and
  tile counters, this wrapper's, when there are several); at most 8 rows
  with no tile named otherwise (q / o / down at decode, where it measured
  faster): the weight-streaming split-K kernel (``csrc/skinny_bf16.cuh``,
  planned by ``_build.skinny_plan``).

A tile is named by the caller (``ops.matmul`` resolves it through the
tuning cache), else the shape-based default of the element type.  The
pipelined variant (depth >= 2) is :mod:`.dense_matmul_pipelined`.

What bounds it on an H100: the CNN path's GEMMs are 1x1 convs over
M = batch * H * W pixels with K, N in 32..192 -- a few FLOP per byte, so
device memory bounds them; the decoder's projections (M = 48 at prefill, a
few rows at decode) are bound by the weights' bytes.  The fused epilogue
keeps every intermediate out of memory.  Routing: a CPU tensor takes
:func:`dense_matmul_plain`, a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches, ``route_launches`` the same launches
by body.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .ref import _ACT, apply_steps_ref, matmul_ref

__all__ = ["dense_matmul", "dense_matmul_plain", "validate_epilogue", "check_operands",
           "bf16_launch", "split_buffers", "layout_dims", "nchw_to_rows", "rows_to_nchw"]

#: kernel launches made by :func:`dense_matmul` (CUDA route only), in all
#: and by element type
launches = 0
dtype_launches = {"f32": 0, "bf16": 0}
#: the same launches by body: ``simt`` (f32), and for bf16 the routes of
#: ``_build.bf16_body`` (``skinny``, ``wgmma``, ``mma_gemm``)
route_launches = {"simt": 0, "skinny": 0, "wgmma": 0, "mma_gemm": 0}


def validate_epilogue(epilogue: Sequence[Tuple], n_sides: int) -> None:
    """Wrapper-side validation shared by every epilogue-capable kernel:
    known activations, slots in range, and the kernels' fixed maxima."""
    _build.validate_program(tuple(epilogue), n_sides)


def layout_dims(name: str, x, w, sides, layout: str):
    """``(m, n, k, p, out_shape)`` of a GEMM in ``layout``: ``"row"`` is
    ``x [M, K]``, ``w [K, N]``, sides and output ``[M, N]`` (``p`` 1);
    ``"nchw"`` is ``x [nb, K, *spatial]``, ``w [N, K]``, sides and output
    ``[nb, N, *spatial]``, with ``p`` the spatial size and ``m = nb * p``."""
    if layout == "row":
        if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
            raise ValueError(f"{name}: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
        (m, k), n, p = x.shape, w.shape[1], 1
        out_shape = (m, n)
    elif layout == "nchw":
        if x.dim() < 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
            raise ValueError(f"{name}: bad NCHW shapes x{tuple(x.shape)} w{tuple(w.shape)}")
        nb, k = x.shape[:2]
        n, p = w.shape[0], math.prod(x.shape[2:])
        m, out_shape = nb * p, (nb, n, *x.shape[2:])
    else:
        raise ValueError(f"{name}: unknown layout {layout!r}")
    for s in sides:
        if tuple(s.shape) != out_shape:
            raise ValueError(f"{name}: side {tuple(s.shape)} != {out_shape}")
    return m, n, k, p, out_shape


def nchw_to_rows(t: torch.Tensor) -> torch.Tensor:
    """``[nb, C, *spatial]`` -> pixel-major ``[nb * prod(spatial), C]`` (a
    copy: the plain versions' view of the NCHW layout)."""
    return t.movedim(1, -1).reshape(-1, t.shape[1]).contiguous()


def rows_to_nchw(y: torch.Tensor, out_shape) -> torch.Tensor:
    """Pixel-major ``[M, N]`` back to ``out_shape`` ``[nb, N, *spatial]``."""
    nb, n, *spatial = out_shape
    return y.reshape(nb, *spatial, n).movedim(-1, 1).contiguous()


def dense_matmul_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *sides: torch.Tensor,
    activation: Optional[str] = None,
    epilogue: Tuple[Tuple, ...] = (),
    _layout: str = "row",
) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments).  The NCHW
    layout is permuted to rows, multiplied, and permuted back."""
    if _layout == "nchw":
        _, _, _, _, out_shape = layout_dims("dense_matmul_plain", x, w, sides, _layout)
        y = dense_matmul_plain(nchw_to_rows(x), w.t().contiguous(), bias,
                               *[nchw_to_rows(s) for s in sides], activation=activation,
                               epilogue=epilogue)
        return rows_to_nchw(y, out_shape)
    y = matmul_ref(x, w, bias, activation=activation, out_dtype=torch.float32)
    return apply_steps_ref(y, epilogue, [s.float() for s in sides]).to(x.dtype)


def check_operands(name, x, w, bias, sides, activation, epilogue, layout="row"):
    """The dense kernels' operand checks (shapes in ``layout``, activation,
    step program); returns ``(m, n, k, p, out_shape, epilogue, device)`` --
    see :func:`layout_dims`; the device from ``_build.kernel_device``, which
    checks what a CUDA launch takes."""
    m, n, k, p, out_shape = layout_dims(name, x, w, sides, layout)
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} != ({n},)")
    if layout == "nchw" and x.dtype == torch.bfloat16:
        raise TypeError(f"{name}: the NCHW layout is the f32 kernels' (bf16 runs row-major)")
    if activation not in _ACT:
        raise ValueError(f"unknown activation {activation!r}")
    epilogue = tuple(tuple(s) for s in epilogue)
    validate_epilogue(epilogue, len(sides))
    named = {f"side{i}": s for i, s in enumerate(sides)}
    operands = dict(x=x, w=w, bias=bias, **named)
    dtypes = {op: x.dtype for op in operands} if x.dtype in _build.FLOAT_CODES else None
    return m, n, k, p, out_shape, epilogue, _build.kernel_device(name, dtypes, **operands)


def dense_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *sides: torch.Tensor,
    activation: Optional[str] = None,
    epilogue: Tuple[Tuple, ...] = (),
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    block_k: Optional[int] = None,
    _layout: str = "row",
) -> torch.Tensor:
    """``epilogue(act(x @ w + bias))`` for 2-D operands, or in the NCHW
    layout (``_layout="nchw"``, f32: see :func:`layout_dims`); see the
    module doc.  Block sizes left as ``None`` come from the shape-based
    default tile of x's element type; a tile the kernel is not built for
    raises ``_build.TileError`` (on the CPU too, where the plain version
    ignores the tile)."""
    global launches
    m, n, k, p, out_shape, epilogue, dev = check_operands(
        "dense_matmul", x, w, bias, sides, activation, epilogue, _layout)
    named = block_m is not None or block_n is not None or block_k is not None
    dm, dn, dk, _ = _build.default_gemm_tile(m, n, x.dtype)
    tile = _build.check_gemm_tile((block_m or dm, block_n or dn, block_k or dk, 1),
                                  "dense_matmul", x.dtype)
    if dev.type == "cpu":
        return dense_matmul_plain(x, w, bias, *sides, activation=activation, epilogue=epilogue,
                                  _layout=_layout)
    out = torch.empty(out_shape, dtype=x.dtype, device=dev)
    prog = _build.encode_program(epilogue)
    side_ptrs = _build.pointer_array(sides)
    route, kchunk, vec, ws, counters = "simt", 0, 0, None, None
    if x.dtype == torch.bfloat16:
        route, kchunk, vec, ws, counters = bf16_launch(dev, x, w, out, m, n, k, tile, named)
        if route == "wgmma" and not named and m <= _build.SKINNY_MT:
            tile = _build.TMA_DECODE_TILE  # decode: the plan's tile, no cache
    lib = _build.lib()
    err = lib.repro_dense_matmul(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), m, n, k, _build.activation_code(activation),
        prog["n"], _build.addr(prog["prog"]), len(sides), _build.addr(side_ptrs),
        _build.FLOAT_CODES[x.dtype], None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), kchunk, vec, int(route == "wgmma"),
        *tile[:3],
        _build.LAYOUT_CODES[_layout], p, _build.stream_handle(),
    )
    _build.check(err, "dense_matmul")
    launches += 1
    dtype_launches["f32" if x.dtype == torch.float32 else "bf16"] += 1
    route_launches[route] += 1
    return out


def bf16_launch(dev, x, w, out, m: int, n: int, k: int, tile, named: bool):
    """``(route, kchunk, vec, ws, counters)`` of a bf16 launch: the body
    ``_build.bf16_body`` picks and its plan -- the skinny kernel's K ranges
    and columns a lane (``vec``), the wgmma body's K ranges, or the
    ``mma.sync`` body's K ranges; with the workspace and tile counters of a
    split skinny or ``mma.sync`` launch."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, out))
    route = _build.bf16_body(m, n, k, named, aligned)
    vec = 0
    if route == "wgmma":
        kchunk, _ = _build.tma_plan(m, n, k)
        return route, kchunk, vec, None, None
    if route == "skinny":
        vec = 8 if n % 8 == 0 and w.data_ptr() % 16 == 0 else 1
        kchunk, nsplit, tiles = _build.skinny_plan(m, n, k, vec)
    else:
        kchunk, nsplit = _build.gemm_split(m, n, k)
        tiles = -(-m // tile[0]) * -(-n // tile[1])
    ws, counters = split_buffers(dev, nsplit, 1, m, n, tiles)
    return route, kchunk, vec, ws, counters


def split_buffers(dev, nsplit: int, n_weights: int, m: int, n: int, tiles: int):
    """The f32 workspace ``[nsplit, n_weights, m, n]`` and the zeroed tile
    counters of a streaming or bf16 launch whose K is split in ``nsplit``
    ranges, or ``(None, None)`` for one range."""
    if nsplit <= 1:
        return None, None
    ws = torch.empty((nsplit, n_weights, m, n), dtype=torch.float32, device=dev)
    return ws, _build.split_counters(dev, tiles)
