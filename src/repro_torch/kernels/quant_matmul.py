"""INT8 matmul with a fused epilogue program: CUDA kernel + plain version.

Replaces the TPU kernel ``repro/kernels/quant_matmul.py:quant_matmul_kernel``
(wrapper ``quant_matmul``).  ``quant_matmul(x, w_q, ws, bias, *sides)``
computes ``epilogue(act((x @ w_q) * ws + bias))`` for 2-D ``x [M, K]`` and
int8 ``w_q [K, N]``, with ``ws [N]`` the combined per-column rescale.  The
activation type selects the scheme, as on the TPU: int8 ``x`` is **W8A8**
(the caller quantized the activations and folded their scale into ``ws``;
int8 x int8 products summed exactly in int32), f32 ``x`` is **W8** (each
int8 weight converted to f32 on chip, f32 accumulation).  The kernel
(``csrc/quant_matmul.cu``) is the dense-matmul tiling with int8 weight
tiles; it masks ragged M / N / K itself, so nothing is padded.  Its tile is
one of ``_build.GEMM_TILES`` at depth 1, named by the caller (``ops.qmatmul``
resolves it through the tuning cache) or the shape-based default; the
pipelined variant (depth >= 2) is :mod:`.quant_matmul_pipelined`.

What bounds it on an H100: the main path's calls are 1x1 convs over
M = batch * H * W pixels with K, N in 32..192 (and one M = batch linear), a
few operations per byte, so device memory bounds them; int8 weights (and,
for W8A8, int8 activations) cut the bytes the kernel reads.  Integer
multiply-add runs on the CUDA cores; the int8 tensor cores are later work.

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
from .dense_matmul import validate_epilogue
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
) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments)."""
    acc = matmul_ref(x, w_q, acc_dtype=torch.float64, out_dtype=torch.float32)
    y = acc * ws.float()
    if bias is not None:
        y = y + bias.float()
    y = _ACT[activation](y)
    return apply_steps_ref(y, epilogue, [s.float() for s in sides])


def check_operands(name, x, w_q, ws, bias, sides, activation, epilogue):
    """The quant kernels' operand checks; returns ``(m, n, k, epilogue,
    device)``, the device from ``_build.kernel_device``."""
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"{name}: bad shapes x{tuple(x.shape)} w{tuple(w_q.shape)}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"{name}: w_q must be int8, got {w_q.dtype}")
    if x.dtype not in (torch.int8, torch.float32):
        raise TypeError(f"{name}: x must be int8 (W8A8) or float32 (W8), got {x.dtype}")
    m, k = x.shape
    n = w_q.shape[1]
    if tuple(ws.shape) != (n,):
        raise ValueError(f"{name}: ws {tuple(ws.shape)} != ({n},)")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} != ({n},)")
    for s in sides:
        if tuple(s.shape) != (m, n):
            raise ValueError(f"{name}: side {tuple(s.shape)} != {(m, n)}")
    if activation not in _ACT:
        raise ValueError(f"unknown activation {activation!r}")
    epilogue = tuple(tuple(s) for s in epilogue)
    validate_epilogue(epilogue, len(sides))
    named = {f"side{i}": s for i, s in enumerate(sides)}
    dev = _build.kernel_device(
        name, {"x": x.dtype, "w_q": torch.int8}, x=x, w_q=w_q, ws=ws, bias=bias, **named,
    )
    return m, n, k, epilogue, dev


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
) -> torch.Tensor:
    """``epilogue(act((x @ w_q) * ws + bias))`` for 2-D operands; int8
    ``x`` selects W8A8, f32 ``x`` W8.  Block sizes left as ``None`` come
    from the shape-based default tile; a tile the kernel is not built for
    raises ``_build.TileError``.  See the module doc."""
    global launches
    m, n, k, epilogue, dev = check_operands("quant_matmul", x, w_q, ws, bias, sides,
                                            activation, epilogue)
    dm, dn, dk, _ = _build.gemm_default_tile(n)
    tile = _build.check_gemm_tile((block_m or dm, block_n or dn, block_k or dk, 1),
                                  "quant_matmul")
    if dev.type == "cpu":
        return quant_matmul_plain(x, w_q, ws, bias, *sides, activation=activation,
                                  epilogue=epilogue)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    prog = _build.encode_program(epilogue)
    side_ptrs = _build.pointer_array(sides)
    lib = _build.lib()
    err = lib.repro_quant_matmul(
        x.data_ptr(), w_q.data_ptr(), ws.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, n, k,
        int(x.dtype == torch.int8), _build.activation_code(activation), prog["n"],
        _build.addr(prog["prog"]), len(sides), _build.addr(side_ptrs), *tile[:3],
        _build.stream_handle(),
    )
    _build.check(err, "quant_matmul")
    launches += 1
    return out
