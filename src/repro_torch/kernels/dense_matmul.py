"""Dense f32 matmul with a fused epilogue program: CUDA kernel + plain version.

Replaces the TPU kernel ``repro/kernels/dense_matmul.py:dense_matmul_kernel``
(wrapper ``dense_matmul``).  ``dense_matmul(x, w, bias, *sides)`` computes
``epilogue(act(x @ w + bias))`` for 2-D ``x [M, K]`` / ``w [K, N]``; the
epilogue is a step program (``("activation", fn)`` / ``("add"|"mul", slot)``
over ``sides``, each ``[M, N]``) run on the f32 accumulator before the one
store.  The kernel (``csrc/dense_matmul.cu``) is a shared-memory tiled GEMM
with FMA on the CUDA cores in true f32, masking ragged M / N / K itself, so
nothing is padded in device memory (the TPU wrapper pads to 128-blocks).

What bounds it on an H100: the main path's GEMMs are 1x1 convs over
M = batch * H * W pixels with K, N in 32..192 -- a few FLOP per byte, so
device memory bounds them; the fused epilogue keeps every intermediate out
of memory.  Routing: a CPU tensor takes :func:`dense_matmul_plain`, a CUDA
tensor launches the kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .ref import _ACT, apply_steps_ref, matmul_ref

__all__ = ["dense_matmul", "dense_matmul_plain", "validate_epilogue"]

#: kernel launches made by :func:`dense_matmul` (CUDA route only)
launches = 0


def validate_epilogue(epilogue: Sequence[Tuple], n_sides: int) -> None:
    """Wrapper-side validation shared by every epilogue-capable kernel:
    known activations, slots in range, and the kernels' fixed maxima."""
    _build.validate_program(tuple(epilogue), n_sides)


def dense_matmul_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *sides: torch.Tensor,
    activation: Optional[str] = None,
    epilogue: Tuple[Tuple, ...] = (),
) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments)."""
    y = matmul_ref(x, w, bias, activation=activation, out_dtype=torch.float32)
    return apply_steps_ref(y, epilogue, [s.float() for s in sides]).to(x.dtype)


def dense_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *sides: torch.Tensor,
    activation: Optional[str] = None,
    epilogue: Tuple[Tuple, ...] = (),
) -> torch.Tensor:
    """``epilogue(act(x @ w + bias))`` for 2-D operands; see the module doc."""
    global launches
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"dense_matmul: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"dense_matmul: bias {tuple(bias.shape)} != ({n},)")
    for s in sides:
        if tuple(s.shape) != (m, n):
            raise ValueError(f"dense_matmul: side {tuple(s.shape)} != {(m, n)}")
    if activation not in _ACT:
        raise ValueError(f"unknown activation {activation!r}")
    epilogue = tuple(tuple(s) for s in epilogue)
    validate_epilogue(epilogue, len(sides))
    named = {f"side{i}": s for i, s in enumerate(sides)}
    dev = _build.kernel_device("dense_matmul", x=x, w=w, bias=bias, **named)
    if dev.type == "cpu":
        return dense_matmul_plain(x, w, bias, *sides, activation=activation, epilogue=epilogue)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    prog = _build.encode_program(epilogue)
    side_ptrs = _build.pointer_array(sides)
    lib = _build.lib()
    err = lib.repro_dense_matmul(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), m, n, k, _build.activation_code(activation),
        prog["n"], _build.addr(prog["prog"]), len(sides), _build.addr(side_ptrs),
        _build.stream_handle(),
    )
    _build.check(err, "dense_matmul")
    launches += 1
    return out
