"""Dense matmul with K slabs streamed through a shared-memory ring: CUDA
kernel (the plain version is :func:`.dense_matmul.dense_matmul_plain`).

Replaces the TPU kernel
``repro/kernels/dense_matmul.py:dense_matmul_pipelined_kernel`` (wrapper
``dense_matmul`` with ``pipeline >= 2``).  The function is
:func:`.dense_matmul.dense_matmul`'s -- ``epilogue(act(x @ w + bias))`` in
f32 or bf16, f32 accumulator and epilogue, one rounding -- and so are the
arguments, plus the tile ``(block_m, block_n, block_k, depth)``, which
must be one of the element type's tiles (``_build.GEMM_TILES``,
``_build.BF16_GEMM_TILES``) with depth >= 2.  The tuning cache
selects it: a winner (or a pin) whose fourth field is 2 or more.

The kernel (``csrc/dense_matmul_pipelined.cu``): for f32, the ring of
``csrc/pipelined_gemm.cuh``, which keeps ``depth - 1`` slabs of x and w in
flight with ``cp.async`` while it multiplies the current one and sums each
output in the tiled kernel's order; for bf16, the tensor-core kernel of
``csrc/mma_gemm.cuh`` at ring depth ``depth`` (``depth + 2`` slots), with
the K ranges ``_build.gemm_split`` fixes from the shape.  Either way its
result is bit-equal to the tiled kernel's.  What bounds it on an H100 is
the tiled kernel's bound: device memory on the CNN path's GEMMs, the
weights' bytes on the decoder's.  Routing: a CPU tensor takes the plain
version (tile and depth ignored, but checked), a CUDA tensor launches the
kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .dense_matmul import check_operands, dense_matmul_plain, split_buffers

__all__ = ["dense_matmul_pipelined"]

#: kernel launches made by :func:`dense_matmul_pipelined` (CUDA route only),
#: in all and by element type
launches = 0
dtype_launches = {"f32": 0, "bf16": 0}


def dense_matmul_pipelined(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *sides: torch.Tensor,
    activation: Optional[str] = None,
    epilogue: Tuple[Tuple, ...] = (),
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    block_k: Optional[int] = None,
    depth: int = 2,
) -> torch.Tensor:
    """``epilogue(act(x @ w + bias))`` through the ring kernel; block sizes
    left as ``None`` come from the shape-based default tile.  A tile (with
    ``depth``) the kernel is not built for raises ``_build.TileError``."""
    global launches
    m, n, k, epilogue, dev = check_operands("dense_matmul_pipelined", x, w, bias, sides,
                                            activation, epilogue)
    dm, dn, dk, _ = _build.default_gemm_tile(m, n, x.dtype)
    tile = _build.check_gemm_tile((block_m or dm, block_n or dn, block_k or dk, depth),
                                  "dense_matmul_pipelined", x.dtype)
    if tile[3] < 2:
        raise _build.TileError(f"dense_matmul_pipelined: depth {tile[3]} is the tiled kernel")
    if dev.type == "cpu":
        return dense_matmul_plain(x, w, bias, *sides, activation=activation, epilogue=epilogue)
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    prog = _build.encode_program(epilogue)
    side_ptrs = _build.pointer_array(sides)
    ws = counters = None
    kchunk = 0
    if x.dtype == torch.bfloat16:
        kchunk, nsplit = _build.gemm_split(m, n, k)
        ws, counters = split_buffers(dev, nsplit, 1, m, n, -(-m // tile[0]) * -(-n // tile[1]))
    err = _build.lib().repro_dense_matmul_pipelined(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), m, n, k, _build.activation_code(activation),
        prog["n"], _build.addr(prog["prog"]), len(sides), _build.addr(side_ptrs),
        _build.FLOAT_CODES[x.dtype], None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), kchunk, *tile,
        _build.stream_handle(),
    )
    _build.check(err, "dense_matmul_pipelined")
    launches += 1
    dtype_launches["f32" if x.dtype == torch.float32 else "bf16"] += 1
    return out
