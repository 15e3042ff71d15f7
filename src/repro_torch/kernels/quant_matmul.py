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
tiles; it masks ragged M / N / K itself, so nothing is padded.

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

__all__ = ["quant_matmul", "quant_matmul_plain"]

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


def quant_matmul(
    x: torch.Tensor,
    w_q: torch.Tensor,
    ws: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *sides: torch.Tensor,
    activation: Optional[str] = None,
    epilogue: Tuple[Tuple, ...] = (),
) -> torch.Tensor:
    """``epilogue(act((x @ w_q) * ws + bias))`` for 2-D operands; int8
    ``x`` selects W8A8, f32 ``x`` W8.  See the module doc."""
    global launches
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"quant_matmul: bad shapes x{tuple(x.shape)} w{tuple(w_q.shape)}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"quant_matmul: w_q must be int8, got {w_q.dtype}")
    if x.dtype not in (torch.int8, torch.float32):
        raise TypeError(f"quant_matmul: x must be int8 (W8A8) or float32 (W8), got {x.dtype}")
    m, k = x.shape
    n = w_q.shape[1]
    if tuple(ws.shape) != (n,):
        raise ValueError(f"quant_matmul: ws {tuple(ws.shape)} != ({n},)")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"quant_matmul: bias {tuple(bias.shape)} != ({n},)")
    for s in sides:
        if tuple(s.shape) != (m, n):
            raise ValueError(f"quant_matmul: side {tuple(s.shape)} != {(m, n)}")
    if activation not in _ACT:
        raise ValueError(f"unknown activation {activation!r}")
    epilogue = tuple(tuple(s) for s in epilogue)
    validate_epilogue(epilogue, len(sides))
    a8 = x.dtype == torch.int8
    named = {f"side{i}": s for i, s in enumerate(sides)}
    dev = _build.kernel_device(
        "quant_matmul", {"x": x.dtype, "w_q": torch.int8},
        x=x, w_q=w_q, ws=ws, bias=bias, **named,
    )
    if dev.type == "cpu":
        return quant_matmul_plain(x, w_q, ws, bias, *sides, activation=activation,
                                  epilogue=epilogue)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    prog = _build.encode_program(epilogue)
    side_ptrs = _build.pointer_array(sides)
    lib = _build.lib()
    err = lib.repro_quant_matmul(
        x.data_ptr(), w_q.data_ptr(), ws.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, n, k, int(a8),
        _build.activation_code(activation), prog["n"], _build.addr(prog["prog"]),
        len(sides), _build.addr(side_ptrs), _build.stream_handle(),
    )
    _build.check(err, "quant_matmul")
    launches += 1
    return out
