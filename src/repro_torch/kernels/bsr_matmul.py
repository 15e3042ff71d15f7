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

The kernel (``csrc/bsr_matmul.cu``) is output-stationary: one CTA per
(8-row M tile, column chunk of a block-column) walks that column's packed
blocks in order, skipping pads, and masks ragged M itself (the TPU wrapper
pads M to its block).  When that grid is small -- decode, a few rows over
a few dozen block-columns -- the wrapper splits each column's steps over
CTAs (``nsplit``) until the grid has about two CTAs per SM, with an f32
workspace and tile counters it allocates; the splits are summed in a fixed
order.  The band loop lives in ``ops.bsr_matmul``.

What bounds it on an H100: the packed weights' bytes at decode (weight
bound, M = batch rows); the design spreads the packed steps over every SM.
Routing: a CPU tensor takes :func:`bsr_matmul_plain`, a CUDA tensor
launches the kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .ref import _ACT, apply_steps_ref, bsr_matmul_ref

__all__ = ["bsr_matmul", "bsr_matmul_plain"]

#: kernel launches made by :func:`bsr_matmul` (CUDA route only)
launches = 0

#: rows of x per CTA (csrc/bsr_matmul.cu BSR_MT)
_MT = 8


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
    global launches
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
    vec = _vec(bn, values)
    tiles = -(-bn // (32 * vec)) * ncols * -(-m // _MT)
    nsplit = 1
    if count > 0:
        nsplit = min(count, max(1, -(-_build.SKINNY_TARGET_BLOCKS // tiles)))
        schunk = -(-count // nsplit)
        nsplit = -(-count // schunk)
    ws = counters = None
    if nsplit > 1:
        ws = torch.empty((nsplit, m, ncols * bn), dtype=torch.float32, device=dev)
        counters = torch.zeros(tiles, dtype=torch.int32, device=dev)
    prog = _build.encode_program(epilogue)
    side_ptrs = _build.pointer_array(sides)
    err = _build.lib().repro_bsr_matmul(
        x.data_ptr(), values.data_ptr(), block_rows.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, k, nb, s, bm, bn,
        start, ncols, count, _build.activation_code(activation), prog["n"],
        _build.addr(prog["prog"]), len(sides), _build.addr(side_ptrs),
        _build.FLOAT_CODES[x.dtype], vec, nsplit, None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), _build.stream_handle(),
    )
    _build.check(err, "bsr_matmul")
    launches += 1
    return out
