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

* ``wgmma`` -- bf16 blocks of ``bm % 32 == 0`` rows and ``bn % 32 == 0``
  columns on 16-byte aligned x and values, at M > 8 (prefill): the
  Hopper GEMM body (``csrc/wgmma_gemm.cuh``, TMA into a swizzled ring,
  ``wgmma`` m64nBNk16) with a block-sparse K walk -- one tensor map over x
  and one over all of ``values``, each CTA's steps of ``block_rows`` staged
  in shared memory and its pads dropped there, a packed block read once per
  64-row M tile as ``bm / BK`` slabs (:func:`tma_bk`);
* ``stream`` -- bf16 with M <= 8 (decode): weight streaming, 16-byte loads
  of the packed rows, several in flight a lane, only M rounded up to 1 / 2
  / 4 / 8 rows of x staged (at the decoder's q / o decode 0.0049 ms against
  the wgmma route's 0.0064-0.0068 on an H100, tools/wgmma_bench.py --bsr);
* ``cuda_core`` -- f32 (true f32) and any other bf16 shape: 8-row M tiles
  on the CUDA cores.

Each route splits a column's packed steps over CTAs when its grid alone
would leave SMs idle (``nsplit``, a function of the shape alone), and the
splits are summed in split order: the wgmma body's in a thread block
cluster through distributed shared memory; the others' in an f32
workspace, by the last CTA of a tile, whose int counter it resets, so the
counters come from ``_build.split_counters`` (one zeroed buffer per
stream, no memset per call).  The band loop lives in ``ops.bsr_matmul``.

What bounds it on an H100: the packed weights' bytes, at decode and at
the decoder's prefill (48 rows).  Routing: a CPU tensor takes
:func:`bsr_matmul_plain`, a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches, ``split_launches`` those with more
than one split, ``route_launches`` the same launches by body.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .ref import _ACT, apply_steps_ref, bsr_matmul_ref

__all__ = ["bsr_matmul", "bsr_matmul_plain", "plan", "BsrPlan", "ROUTES", "rows_per_tile",
           "tma_bk", "tma_grid"]

#: kernel launches made by :func:`bsr_matmul` (CUDA route only)
launches = 0
#: the launches among them whose steps were split across CTAs
split_launches = 0
#: the same launches by body (:data:`ROUTES`)
route_launches = {"cuda_core": 0, "wgmma": 0, "stream": 0}

#: the kernel's bodies, by the code its C entry takes (csrc/bsr_matmul.cu)
ROUTES = {"cuda_core": 0, "wgmma": 1, "stream": 2}
#: rows of x a CTA covers: the CUDA-core body's M tile, the wgmma body's,
#: and the most rows the streaming body takes (its M tile)
FMA_MT, TMA_MT, STREAM_MAX_M = 8, 64, 8
#: the streaming body's columns a CTA, the most packed rows (steps x bm) it
#: stages, and the fewest it should stream (csrc/bsr_matmul.cu bsr_stream::
#: CW, KC; _build.SKINNY_MIN_K)
STREAM_CW, STREAM_KC, STREAM_MIN_ROWS = 16, 1024, _build.SKINNY_MIN_K
#: the wgmma body's most splits (the CTAs of a thread block cluster) and
#: most steps a CTA (the block_rows table it stages: csrc/wgmma_gemm.cuh
#: BsrWalk::TABLE)
TMA_MAX_SPLIT, TMA_MAX_STEPS = _build.TMA_MAX_CLUSTER, 256
#: the CTAs each route's split aims for: two per SM of an H100's 132 for the
#: CUDA-core body (8 warps, a few loads in flight each); one per SM for the
#: wgmma body (at the decoder's q / o prefill 4 splits of 4 steps ran
#: 0.0067 / 0.0069 ms against 8 splits' 0.0072 / 0.0072 and no split's
#: 0.0106 / 0.0111, tools/wgmma_bench.py --bsr) and for the streaming body,
#: whose CTA has all its rows' loads in flight at once: it splits only
#: while whole splits still fit one CTA a SM (on q decode no split ran 30%
#: faster than 2, --stream-target)
FMA_TARGET, TMA_TARGET, STREAM_TARGET = (_build.SKINNY_TARGET_BLOCKS, _build.SPLIT_TARGET_BLOCKS,
                                         _build.SPLIT_TARGET_BLOCKS)


class BsrPlan(NamedTuple):
    """One launch of the kernel: the body, its width (``cuda_core``: columns
    a lane; ``wgmma``: columns a CTA; ``stream``: 16, columns a CTA), the
    split of each column's steps (``nsplit`` CTAs of ``schunk`` steps,
    every one non-empty) and the tiles of the grid (one counter each where
    the splits meet through ``_build.split_counters``: not the wgmma body,
    whose splits meet in a thread block cluster)."""

    route: str
    width: int
    nsplit: int
    schunk: int
    tiles: int


def tma_bk(bm: int) -> int:
    """The wgmma route's slab rows for ``bm``-row blocks: the largest of
    128 / 64 / 32 that divides ``bm`` (0: none does, the route refuses)."""
    return next((bk for bk in (128, 64, 32) if bm % bk == 0), 0)


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
    boundaries (the wgmma and streaming bodies' copies); ``vec``: the
    CUDA-core body's columns a lane (:func:`_vec`).

    bf16 with ``m <= 8`` and ``bm <= 1024`` streams; other bf16 launches
    of ``bm % 32 == 0`` and ``bn % 32 == 0`` take the wgmma body (up to 8 x
    256 steps a column: its splits form one thread block cluster, each
    stages its steps); everything else (f32, an unaligned operand, another
    block shape) runs on the CUDA cores."""
    tma = (bf16 and aligned and tma_bk(bm) > 0 and bn % 32 == 0
           and count <= TMA_MAX_SPLIT * TMA_MAX_STEPS)
    if bf16 and aligned and m <= STREAM_MAX_M and bm <= STREAM_KC:
        tiles = _cdiv(bn, STREAM_CW) * ncols
        nsplit, schunk = _split(count, max(1, STREAM_TARGET // tiles),
                                least=_cdiv(STREAM_MIN_ROWS, bm), most=STREAM_KC // bm)
        return BsrPlan("stream", STREAM_CW, nsplit, schunk, tiles)
    if tma:
        width = 64 if bn % 64 == 0 else 32
        tiles = bn // width * ncols * _cdiv(m, TMA_MT)
        want = min(_cdiv(TMA_TARGET, tiles), TMA_MAX_SPLIT)
        nsplit, schunk = _split(count, want, least=_cdiv(count, TMA_MAX_SPLIT),
                                most=TMA_MAX_STEPS)
        return BsrPlan("wgmma", width, nsplit, schunk, tiles)
    tiles = _cdiv(bn, 32 * vec) * ncols * _cdiv(m, FMA_MT)
    nsplit, schunk = _split(count, _cdiv(FMA_TARGET, tiles))
    return BsrPlan("cuda_core", vec, nsplit, schunk, tiles)


def tma_grid(m: int, bm: int, bn: int, ncols: int, p: BsrPlan) -> Tuple[Tuple[int, int, int], int]:
    """The wgmma route's launch: its grid ``(M tiles, N tiles, splits)`` --
    a 64-row M tile by ``p.width`` columns of a block-column by one split
    of each column's steps, the splits of a tile one thread block cluster
    -- and the rows of a slab (:func:`tma_bk`), as ``csrc/bsr_matmul.cu``
    launches ``wgmma_gemm::BsrWalk``."""
    return (_cdiv(m, TMA_MT), bn // p.width * ncols, p.nsplit), tma_bk(bm)


def rows_per_tile(m: int, bm: int, bn: int, dtype: torch.dtype) -> int:
    """Rows of x one CTA covers for a call of this shape (aligned operands):
    the wgmma body's 64 or the other bodies' 8 -- what the ops layer
    records as the kernel's one configuration of a tuning key."""
    route = plan(m, bm, bn, 1, 1, dtype == torch.bfloat16).route
    return TMA_MT if route == "wgmma" else FMA_MT


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
    if p.route == "wgmma" and tma_grid(m, bm, bn, ncols, p)[0][1] > 65535:
        raise ValueError(f"bsr_matmul: {ncols} block-columns of {bn // p.width} N tiles pass "
                         f"the grid's 65535 (x{tuple(x.shape)} values{tuple(values.shape)})")
    ws = counters = None
    if p.nsplit > 1 and p.route != "wgmma":  # its splits meet in a cluster
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
    route_launches[p.route] += 1
    return out
