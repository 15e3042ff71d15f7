"""INT8 matmul with K slabs streamed through a shared-memory ring: CUDA
kernel (the plain version is :func:`.quant_matmul.quant_matmul_plain`).

Replaces the TPU kernel
``repro/kernels/quant_matmul.py:quant_matmul_pipelined_kernel`` (wrapper
``quant_matmul`` with ``pipeline >= 2``).  The function and arguments are
:func:`.quant_matmul.quant_matmul`'s -- ``epilogue(act((x @ w_q) * ws +
bias))``, int8 ``x`` for W8A8 (exact int32 sums), f32 ``x`` for W8 --
plus the tile ``(block_m, block_n, block_k, depth)``, one of
``_build.GEMM_TILES`` with depth >= 2.  The tuning cache selects it: a
``qmatmul`` winner (or a pin) whose fourth field is 2 or more.

The kernel (``csrc/quant_matmul_pipelined.cu``) runs the tiled kernel's
bodies at ring depth ``depth`` (W8: ``csrc/simt_gemm.cuh``, W8A8:
``csrc/int8_gemm.cuh``), in either layout (``_layout``), so its result is
bit-equal to the tiled kernel's.  Device memory bounds it on the main path, as it bounds the
tiled kernel.  Routing: a CPU tensor takes the plain version (tile and
depth checked, then ignored), a CUDA tensor launches the kernel or
raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .quant_matmul import check_operands, quant_matmul_plain

__all__ = ["quant_matmul_pipelined"]

#: kernel launches made by :func:`quant_matmul_pipelined` (CUDA route only)
launches = 0


def quant_matmul_pipelined(
    x: torch.Tensor,
    w_q: torch.Tensor,
    ws: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *sides: torch.Tensor,
    activation: Optional[str] = None,
    epilogue: Tuple[Tuple, ...] = (),
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    block_k: Optional[int] = None,
    depth: int = 2,
    _layout: str = "row",
) -> torch.Tensor:
    """``epilogue(act((x @ w_q) * ws + bias))`` through the ring kernel;
    block sizes left as ``None`` come from the shape-based default tile.  A
    tile (with ``depth``) the kernel is not built for raises
    ``_build.TileError``."""
    global launches
    m, n, k, p, out_shape, epilogue, dev = check_operands(
        "quant_matmul_pipelined", x, w_q, ws, bias, sides, activation, epilogue, _layout)
    dm, dn, dk, _ = _build.gemm_default_tile(n)
    tile = _build.check_gemm_tile((block_m or dm, block_n or dn, block_k or dk, depth),
                                  "quant_matmul_pipelined")
    if tile[3] < 2:
        raise _build.TileError(f"quant_matmul_pipelined: depth {tile[3]} is the tiled kernel")
    if dev.type == "cpu":
        return quant_matmul_plain(x, w_q, ws, bias, *sides, activation=activation,
                                  epilogue=epilogue, _layout=_layout)
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    prog = _build.encode_program(epilogue)
    side_ptrs = _build.pointer_array(sides)
    err = _build.lib().repro_quant_matmul_pipelined(
        x.data_ptr(), w_q.data_ptr(), ws.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, n, k,
        int(x.dtype == torch.int8), _build.activation_code(activation), prog["n"],
        _build.addr(prog["prog"]), len(sides), _build.addr(side_ptrs), *tile,
        _build.LAYOUT_CODES[_layout], p, _build.stream_handle(),
    )
    _build.check(err, "quant_matmul_pipelined")
    launches += 1
    return out
