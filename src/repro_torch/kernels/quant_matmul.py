"""INT8 matmul with a fused epilogue program: CUDA kernel + plain version.

Replaces the TPU kernel ``repro/kernels/quant_matmul.py:quant_matmul_kernel``
(wrapper ``quant_matmul``).  ``quant_matmul(x, w_q, ws, bias, *sides)``
computes ``epilogue(act((x @ w_q) * ws + bias))`` for 2-D ``x [M, K]`` and
int8 ``w_q [K, N]``, with ``ws [N]`` the combined per-column rescale.  The
activation type selects the scheme, as on the TPU: int8 ``x`` is **W8A8**
(the caller quantized the activations and folded their scale into ``ws``;
int8 x int8 products summed exactly in int32), f32 ``x`` is **W8** (each
int8 weight converted to f32 on chip, f32 accumulation).  The kernel
(``csrc/quant_matmul.cu``) runs W8 on the f32 GEMM's CUDA-core body
(``csrc/simt_gemm.cuh``) and W8A8 on int8 tensor cores
(``csrc/int8_gemm.cuh``: ``mma.sync`` m16n8k32 s8); it masks ragged M / N /
K itself, so nothing is padded.  Both take the row-major layout or, for
the 1x1-conv path (``_layout="nchw"``), ``x [nb, K, OH, OW]``, ``w_q [N,
K]`` and ``out [nb, N, OH, OW]`` where they lie
(:func:`.dense_matmul.layout_dims`).  Its tile is one of
``_build.GEMM_TILES`` at depth 1, named by the caller (``ops.qmatmul``
resolves it through the tuning cache) or the shape-based default; the
pipelined variant (depth >= 2) is :mod:`.quant_matmul_pipelined`.

What bounds it on an H100: the main path's calls are 1x1 convs over
M = batch * H * W pixels with K, N in 32..192 (and one M = batch linear), a
few operations per byte, so device memory bounds them; int8 weights (and,
for W8A8, int8 activations) cut the bytes the kernel reads.

The plain version accumulates in float64, which is exact for W8A8 (the
integer sums stay far below 2^53; a float32 sum is not exact past 2^24, and
cuBLAS has no int32 GEMM), then rescales in f32 like the kernel.  Routing: a
CPU tensor takes :func:`quant_matmul_plain`, a CUDA tensor launches the
kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .dense_matmul import layout_dims, nchw_to_rows, rows_to_nchw, validate_epilogue
from .ref import _ACT, apply_steps_ref, matmul_ref

__all__ = ["quant_matmul", "quant_matmul_plain", "check_operands"]

#: kernel launches made by :func:`quant_matmul` (CUDA route only)
launches = 0


def quant_matmul_plain(
    x: torch.Tensor,
    w_q: torch.Tensor,
    ws: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *sides: torch.Tensor,
    activation: Optional[str] = None,
    epilogue: Tuple[Tuple, ...] = (),
    _layout: str = "row",
) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments).  The NCHW
    layout is permuted to rows, multiplied, and permuted back."""
    if _layout == "nchw":
        _, _, _, _, out_shape = layout_dims("quant_matmul_plain", x, w_q, sides, _layout)
        y = quant_matmul_plain(nchw_to_rows(x), w_q.t().contiguous(), ws, bias,
                               *[nchw_to_rows(s) for s in sides], activation=activation,
                               epilogue=epilogue)
        return rows_to_nchw(y, out_shape)
    acc = matmul_ref(x, w_q, acc_dtype=torch.float64, out_dtype=torch.float32)
    y = acc * ws.float()
    if bias is not None:
        y = y + bias.float()
    y = _ACT[activation](y)
    return apply_steps_ref(y, epilogue, [s.float() for s in sides])


def check_operands(name, x, w_q, ws, bias, sides, activation, epilogue, layout="row"):
    """The quant kernels' operand checks (shapes in ``layout``); returns
    ``(m, n, k, p, out_shape, epilogue, device)`` as
    :func:`.dense_matmul.check_operands` does."""
    m, n, k, p, out_shape = layout_dims(name, x, w_q, sides, layout)
    if w_q.dtype != torch.int8:
        raise TypeError(f"{name}: w_q must be int8, got {w_q.dtype}")
    if x.dtype not in (torch.int8, torch.float32):
        raise TypeError(f"{name}: x must be int8 (W8A8) or float32 (W8), got {x.dtype}")
    if tuple(ws.shape) != (n,):
        raise ValueError(f"{name}: ws {tuple(ws.shape)} != ({n},)")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} != ({n},)")
    if activation not in _ACT:
        raise ValueError(f"unknown activation {activation!r}")
    epilogue = tuple(tuple(s) for s in epilogue)
    validate_epilogue(epilogue, len(sides))
    named = {f"side{i}": s for i, s in enumerate(sides)}
    dev = _build.kernel_device(
        name, {"x": x.dtype, "w_q": torch.int8}, x=x, w_q=w_q, ws=ws, bias=bias, **named,
    )
    return m, n, k, p, out_shape, epilogue, dev


def quant_matmul(
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
    _layout: str = "row",
) -> torch.Tensor:
    """``epilogue(act((x @ w_q) * ws + bias))`` for 2-D operands, or in
    the NCHW layout (``_layout="nchw"``); int8 ``x`` selects W8A8, f32 ``x``
    W8.  Block sizes left as ``None`` come from the shape-based default
    tile; a tile the kernel is not built for raises ``_build.TileError``.
    See the module doc."""
    global launches
    m, n, k, p, out_shape, epilogue, dev = check_operands(
        "quant_matmul", x, w_q, ws, bias, sides, activation, epilogue, _layout)
    dm, dn, dk, _ = _build.gemm_default_tile(n)
    tile = _build.check_gemm_tile((block_m or dm, block_n or dn, block_k or dk, 1),
                                  "quant_matmul")
    if dev.type == "cpu":
        return quant_matmul_plain(x, w_q, ws, bias, *sides, activation=activation,
                                  epilogue=epilogue, _layout=_layout)
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    prog = _build.encode_program(epilogue)
    side_ptrs = _build.pointer_array(sides)
    lib = _build.lib()
    err = lib.repro_quant_matmul(
        x.data_ptr(), w_q.data_ptr(), ws.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, n, k,
        int(x.dtype == torch.int8), _build.activation_code(activation), prog["n"],
        _build.addr(prog["prog"]), len(sides), _build.addr(side_ptrs), *tile[:3],
        _build.LAYOUT_CODES[_layout], p, _build.stream_handle(),
    )
    _build.check(err, "quant_matmul")
    launches += 1
    return out
