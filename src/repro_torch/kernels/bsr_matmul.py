"""Block-sparse matmul over PBCSR-packed weights with a fused epilogue
program: CUDA kernel + plain version.

Replaces the TPU kernel ``repro/kernels/bsr_matmul.py:bsr_matmul_kernel``
(wrapper ``bsr_matmul``).  ``bsr_matmul(x, values, block_rows, bias,
*sides, band=(start, stop, count), out=out)`` computes
``epilogue(act(x @ W + bias))`` for the output block-columns
``[start, stop)`` of one band, walking ``count`` packed steps of each, and
writes them into their columns of ``out [M, Nb * bn]`` (allocated when not
given); without ``band`` it covers every column with all ``S`` steps.
``x [M, K]``; ``values [Nb, S, bm, bn]`` (zeros at pads) and ``block_rows
[Nb, S]`` int32 (-1 = pad) as ``core.sparse.PBCSR`` packs them; ``bias
[Nb * bn]``; the epilogue's ``sides [M, Nb * bn]``.  Operands share one
element type, f32 or bf16; the accumulator, bias, activation and step
program are f32 and the output takes x's type, rounded once.  ``bm`` and
``bn`` may be any multiple of 8.

The kernel (``csrc/bsr_matmul.cu``) has three bodies; :func:`plan` picks
one from the shape before the launch (never as a retry):

* ``tensor_core`` -- bf16 with M > 8 (prefill) and ``bm % 16 == 0``: one
  CTA per 64-row M tile by a 64- (or 32-) column chunk of a block-column
  runs ``mma.sync`` over each packed block as K slabs through a
  ``cp.async`` ring, so a weight block is read once per M tile;
* ``stream`` -- bf16 with M <= 8 (decode): weight streaming, 16-byte loads
  of the packed rows, several in flight a lane, only M rounded up to 1 /
  2 / 4 / 8 rows of x staged;
* ``cuda_core`` -- f32 (true f32) and any other bf16 shape: 8-row M tiles
  on the CUDA cores.

Each route splits a column's packed steps over CTAs when its grid alone
would leave SMs idle (``nsplit``, a function of the shape alone), and the
splits are summed in split order: the tensor-core body's in a thread block
cluster through distributed shared memory; the others' in an f32
workspace, by the last CTA of a tile, whose int counter it resets, so the
counters come from ``_build.split_counters`` (one zeroed buffer per
stream, no memset per call).  The band loop lives in ``ops.bsr_matmul``.

What bounds it on an H100: the packed weights' bytes, at decode and at
the decoder's prefill (48 rows).  Routing: a CPU tensor takes
:func:`bsr_matmul_plain`, a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches, ``split_launches`` those with more
than one split.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .ref import _ACT, apply_steps_ref, bsr_matmul_ref

__all__ = ["bsr_matmul", "bsr_matmul_plain", "plan", "BsrPlan", "ROUTES", "rows_per_tile"]

#: kernel launches made by :func:`bsr_matmul` (CUDA route only)
launches = 0
#: the launches among them whose steps were split across CTAs
split_launches = 0

#: the kernel's bodies, by the code its C entry takes (csrc/bsr_matmul.cu)
ROUTES = {"cuda_core": 0, "tensor_core": 1, "stream": 2}
#: rows of x a CTA covers: the CUDA-core body's M tile, the tensor-core
#: body's, and the most rows the streaming body takes (its M tile)
FMA_MT, MMA_MT, STREAM_MAX_M = 8, 64, 8
#: the streaming body's columns a CTA, the most packed rows (steps x bm) it
#: stages, and the fewest it should stream (csrc/bsr_matmul.cu bsr_stream::
#: CW, KC; _build.SKINNY_MIN_K)
STREAM_CW, STREAM_KC, STREAM_MIN_ROWS = 16, 1024, _build.SKINNY_MIN_K
#: the tensor-core body's most splits (the CTAs of a thread block cluster)
#: and most steps a CTA (csrc/bsr_matmul.cu bsr_mma::MAX_SPLIT, MAX_STEPS)
MMA_MAX_SPLIT, MMA_MAX_STEPS = 8, 256
#: the CTAs each route's split aims for: two per SM of an H100's 132 for the
#: CUDA-core body (8 warps, a few loads in flight each) and the tensor-core
#: body (a 74 KB ring each; on the decoder's q prefill 8 splits ran 8%
#: faster than 4 on an H100, tools/bsr_conv_bench.py --mma-target), one per
#: SM for the streaming body, whose CTA has all its rows' loads in flight
#: at once: it splits only while whole splits still fit one CTA a SM (on
#: q decode no split ran 30% faster than 2, --stream-target)
FMA_TARGET, MMA_TARGET, STREAM_TARGET = (_build.SKINNY_TARGET_BLOCKS, _build.SKINNY_TARGET_BLOCKS,
                                         _build.SPLIT_TARGET_BLOCKS)


class BsrPlan(NamedTuple):
    """One launch of the kernel: the body, its width (``cuda_core``: columns
    a lane; ``tensor_core``: columns a CTA; ``stream``: 16, columns a CTA),
    the split of each column's steps (``nsplit`` CTAs of ``schunk`` steps,
    every one non-empty) and the tiles of the grid (one counter each where
    the splits meet through ``_build.split_counters``: not the tensor-core
    body, whose splits meet in a thread block cluster)."""

    route: str
    width: int
    nsplit: int
    schunk: int
    tiles: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(count: int, want: int, least: int = 1, most: Optional[int] = None):
    """``(nsplit, schunk)``: about ``want`` splits of ``count`` steps, each at
    least ``least`` and at most ``most`` steps (``least`` yields to
    ``count``), every split non-empty; one for an empty band."""
    if count <= 0:
        return 1, max(count, 0)
    schunk = max(_cdiv(count, max(1, min(count, want))), min(least, count))
    if most is not None:
        schunk = min(schunk, most)
    return _cdiv(count, schunk), schunk


def plan(m: int, bm: int, bn: int, ncols: int, count: int, bf16: bool,
         aligned: bool = True, vec: int = 1) -> BsrPlan:
    """The route and split of one band's launch, from its shape alone: ``m``
    rows of x, ``bm x bn`` blocks, ``ncols`` block-columns walked for
    ``count`` steps; ``bf16`` operands; ``aligned``: x and values on 16-byte
    boundaries (the tensor-core and streaming bodies' copies); ``vec``: the
    CUDA-core body's columns a lane (:func:`_vec`).

    bf16 with ``m <= 8`` and ``bm <= 1024`` streams; bf16 with ``m > 8`` and
    ``bm % 16 == 0`` takes the tensor cores (up to 8 x 256 steps a
    column: its splits form one thread block cluster); everything else
    (f32, an unaligned operand, another block shape) the CUDA cores."""
    if bf16 and aligned and m <= STREAM_MAX_M and bm <= STREAM_KC:
        tiles = _cdiv(bn, STREAM_CW) * ncols
        nsplit, schunk = _split(count, max(1, STREAM_TARGET // tiles),
                                least=_cdiv(STREAM_MIN_ROWS, bm), most=STREAM_KC // bm)
        return BsrPlan("stream", STREAM_CW, nsplit, schunk, tiles)
    if (bf16 and aligned and m > STREAM_MAX_M and bm % 16 == 0
            and count <= MMA_MAX_SPLIT * MMA_MAX_STEPS):
        width = 64 if bn % 64 == 0 else 32
        tiles = _cdiv(bn, width) * ncols * _cdiv(m, MMA_MT)
        want = min(_cdiv(MMA_TARGET, tiles), MMA_MAX_SPLIT)
        nsplit, schunk = _split(count, want, least=_cdiv(count, MMA_MAX_SPLIT),
                                most=MMA_MAX_STEPS)
        return BsrPlan("tensor_core", width, nsplit, schunk, tiles)
    tiles = _cdiv(bn, 32 * vec) * ncols * _cdiv(m, FMA_MT)
    nsplit, schunk = _split(count, _cdiv(FMA_TARGET, tiles))
    return BsrPlan("cuda_core", vec, nsplit, schunk, tiles)


def rows_per_tile(m: int, bm: int, dtype: torch.dtype) -> int:
    """Rows of x one CTA covers for a call of this shape (aligned operands):
    the tensor-core body's 64 or the other bodies' 8 -- what the ops layer
    records as the kernel's one configuration of a tuning key."""
    route = plan(m, bm, 8, 1, 1, dtype == torch.bfloat16).route
    return MMA_MT if route == "tensor_core" else FMA_MT


def _check(x, values, block_rows, bias, sides, band, out, activation, epilogue):
    """Validate the call; returns ``(start, stop, count)``."""
    if x.dim() != 2 or values.dim() != 4 or block_rows.dim() != 2:
        raise ValueError(f"bsr_matmul: bad ranks x{tuple(x.shape)} values"
                         f"{tuple(values.shape)} block_rows{tuple(block_rows.shape)}")
    m, k = x.shape
    nb, s, bm, bn = values.shape
    if bm % 8 or bn % 8:
        raise ValueError(f"bsr_matmul: block ({bm}, {bn}) must be multiples of 8")
    if k % bm:
        raise ValueError(f"bsr_matmul: K={k} is not a multiple of bm={bm}")
    if tuple(block_rows.shape) != (nb, s):
        raise ValueError(f"bsr_matmul: block_rows {tuple(block_rows.shape)} != {(nb, s)}")
    n = nb * bn
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bsr_matmul: bias {tuple(bias.shape)} != ({n},)")
    for sv in sides:
        if tuple(sv.shape) != (m, n):
            raise ValueError(f"bsr_matmul: side {tuple(sv.shape)} != {(m, n)}")
    if out is not None and (tuple(out.shape) != (m, n) or out.dtype != x.dtype):
        raise ValueError(f"bsr_matmul: out {tuple(out.shape)} {out.dtype} != {(m, n)} {x.dtype}")
    start, stop, count = band if band is not None else (0, nb, s)
    if not (0 <= start <= stop <= nb and 0 <= count <= s):
        raise ValueError(f"bsr_matmul: band {band} outside ({nb} columns, {s} steps)")
    if activation not in _ACT:
        raise ValueError(f"unknown activation {activation!r}")
    _build.validate_program(epilogue, len(sides))
    return int(start), int(stop), int(count)


def bsr_matmul_plain(
    x: torch.Tensor,
    values: torch.Tensor,
    block_rows: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *sides: torch.Tensor,
    activation: Optional[str] = None,
    epilogue: Tuple[Tuple, ...] = (),
    band: Optional[Tuple[int, int, int]] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments): the band's
    slice through ``bsr_matmul_ref`` at f32, the step program, one cast."""
    nb, s, _, bn = values.shape
    start, stop, count = band if band is not None else (0, nb, s)
    cols = slice(start * bn, stop * bn)
    y = bsr_matmul_ref(
        x, values[start:stop, :count], block_rows[start:stop, :count],
        None if bias is None else bias[cols], activation=activation, out_dtype=torch.float32,
    )
    y = apply_steps_ref(y, tuple(epilogue), [sv[:, cols].float() for sv in sides]).to(x.dtype)
    if out is None:
        if band is None:
            return y
        out = x.new_empty((x.shape[0], nb * bn))
    out[:, cols] = y
    return out


def _vec(bn: int, values: torch.Tensor) -> int:
    """Columns per lane: the widest of 4 / 2 / 1 that divides bn without
    leaving most of a warp idle, on an aligned values pointer."""
    for v in (4, 2):
        if bn % v == 0 and 32 * v <= bn and values.data_ptr() % (v * values.element_size()) == 0:
            return v
    return 1


def plan_for(x: torch.Tensor, values: torch.Tensor, ncols: int, count: int) -> BsrPlan:
    """:func:`plan` of a launch on these operands (their alignment and the
    CUDA-core body's column width read from the pointers)."""
    _, _, bm, bn = values.shape
    aligned = x.data_ptr() % 16 == 0 and values.data_ptr() % 16 == 0
    return plan(x.shape[0], bm, bn, ncols, count, x.dtype == torch.bfloat16, aligned,
                _vec(bn, values))


def bsr_matmul(
    x: torch.Tensor,
    values: torch.Tensor,
    block_rows: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *sides: torch.Tensor,
    activation: Optional[str] = None,
    epilogue: Tuple[Tuple, ...] = (),
    band: Optional[Tuple[int, int, int]] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One band of ``epilogue(act(x @ W + bias))``; see the module doc."""
    global launches, split_launches
    epilogue = tuple(tuple(st) for st in epilogue)
    start, stop, count = _check(x, values, block_rows, bias, sides, band, out, activation,
                                epilogue)
    named = {f"side{i}": sv for i, sv in enumerate(sides)}
    operands = dict(x=x, values=values, block_rows=block_rows, bias=bias, out=out, **named)
    dtypes = None
    if x.dtype in _build.FLOAT_CODES:
        dtypes = {name: x.dtype for name in operands}
        dtypes["block_rows"] = torch.int32
    dev = _build.kernel_device("bsr_matmul", dtypes, **operands)
    if dev.type == "cpu":
        return bsr_matmul_plain(x, values, block_rows, bias, *sides, activation=activation,
                                epilogue=epilogue, band=band, out=out)
    m, k = x.shape
    nb, s, bm, bn = values.shape
    if out is None:
        out = torch.empty((m, nb * bn), dtype=x.dtype, device=dev)
    ncols = stop - start
    if m == 0 or ncols == 0:
        return out
    p = plan_for(x, values, ncols, count)
    ws = counters = None
    if p.nsplit > 1 and p.route != "tensor_core":  # its splits meet in a cluster
        ws = torch.empty((p.nsplit, m, ncols * bn), dtype=torch.float32, device=dev)
        counters = _build.split_counters(dev, p.tiles)
    prog = _build.encode_program(epilogue)
    side_ptrs = _build.pointer_array(sides)
    err = _build.lib().repro_bsr_matmul(
        x.data_ptr(), values.data_ptr(), block_rows.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, k, nb, s, bm, bn,
        start, ncols, count, _build.activation_code(activation), prog["n"],
        _build.addr(prog["prog"]), len(sides), _build.addr(side_ptrs),
        _build.FLOAT_CODES[x.dtype], ROUTES[p.route], p.width, p.nsplit,
        None if ws is None else ws.data_ptr(), None if counters is None else counters.data_ptr(),
        _build.stream_handle(),
    )
    _build.check(err, f"bsr_matmul ({p.route}, x{tuple(x.shape)} values{tuple(values.shape)})")
    launches += 1
    split_launches += p.nsplit > 1
    return out
