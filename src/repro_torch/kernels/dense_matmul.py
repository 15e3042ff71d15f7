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

* f32: a shared-memory tiled GEMM with FMA on the CUDA cores in true f32;
  its tile ``(block_m, block_n, block_k)`` is one of ``_build.GEMM_TILES``
  at depth 1;
* bf16: the tensor-core kernel (``csrc/mma_gemm.cuh``: cp.async ring,
  ``ldmatrix`` + ``mma.sync`` m16n8k16, f32 accumulators) with a tile of
  ``_build.BF16_GEMM_TILES`` at depth 1, its K split into the ranges
  ``_build.gemm_split`` fixes from the shape (an f32 workspace and tile
  counters, this wrapper's, when there are several);
* bf16 with at most 8 rows and no tile named (the decoder's projections
  at decode): the weight-streaming split-K kernel
  (``csrc/skinny_bf16.cuh``, planned by ``_build.skinny_plan``).

A tile is named by the caller (``ops.matmul`` resolves it through the
tuning cache), else the shape-based default of the element type.  The
pipelined variant (depth >= 2) is :mod:`.dense_matmul_pipelined`.

What bounds it on an H100: the CNN path's GEMMs are 1x1 convs over
M = batch * H * W pixels with K, N in 32..192 -- a few FLOP per byte, so
device memory bounds them; the decoder's projections (M = 48 at prefill, a
few rows at decode) are bound by the weights' bytes.  The fused epilogue
keeps every intermediate out of memory.  Routing: a CPU tensor takes
:func:`dense_matmul_plain`, a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .ref import _ACT, apply_steps_ref, matmul_ref

__all__ = ["dense_matmul", "dense_matmul_plain", "validate_epilogue", "check_operands",
           "split_buffers"]

#: kernel launches made by :func:`dense_matmul` (CUDA route only), in all
#: and by element type
launches = 0
dtype_launches = {"f32": 0, "bf16": 0}


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


def check_operands(name, x, w, bias, sides, activation, epilogue):
    """The dense kernels' operand checks (shapes, activation, step program);
    returns ``(m, n, k, epilogue, device)`` -- the device from
    ``_build.kernel_device``, which checks what a CUDA launch takes."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
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
    operands = dict(x=x, w=w, bias=bias, **named)
    dtypes = {op: x.dtype for op in operands} if x.dtype in _build.FLOAT_CODES else None
    return m, n, k, epilogue, _build.kernel_device(name, dtypes, **operands)


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
) -> torch.Tensor:
    """``epilogue(act(x @ w + bias))`` for 2-D operands; see the module doc.
    Block sizes left as ``None`` come from the shape-based default tile of
    x's element type; a tile the kernel is not built for raises
    ``_build.TileError`` (on the CPU too, where the plain version ignores
    the tile)."""
    global launches
    m, n, k, epilogue, dev = check_operands("dense_matmul", x, w, bias, sides, activation,
                                            epilogue)
    named = block_m is not None or block_n is not None or block_k is not None
    dm, dn, dk, _ = _build.default_gemm_tile(m, n, x.dtype)
    tile = _build.check_gemm_tile((block_m or dm, block_n or dn, block_k or dk, 1),
                                  "dense_matmul", x.dtype)
    if dev.type == "cpu":
        return dense_matmul_plain(x, w, bias, *sides, activation=activation, epilogue=epilogue)
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    prog = _build.encode_program(epilogue)
    side_ptrs = _build.pointer_array(sides)
    ws = counters = None
    kchunk = vec = 0
    if x.dtype == torch.bfloat16:
        if m <= _build.SKINNY_MT and k > 0 and not named:
            vec = 8 if n % 8 == 0 and w.data_ptr() % 16 == 0 else 1
            kchunk, nsplit, tiles = _build.skinny_plan(m, n, k, vec)
        else:
            kchunk, nsplit = _build.gemm_split(m, n, k)
            tiles = -(-m // tile[0]) * -(-n // tile[1])
        ws, counters = split_buffers(dev, nsplit, 1, m, n, tiles)
    lib = _build.lib()
    err = lib.repro_dense_matmul(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), m, n, k, _build.activation_code(activation),
        prog["n"], _build.addr(prog["prog"]), len(sides), _build.addr(side_ptrs),
        _build.FLOAT_CODES[x.dtype], None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), kchunk, vec, *tile[:3],
        _build.stream_handle(),
    )
    _build.check(err, "dense_matmul")
    launches += 1
    dtype_launches["f32" if x.dtype == torch.float32 else "bf16"] += 1
    return out


def split_buffers(dev, nsplit: int, n_weights: int, m: int, n: int, tiles: int):
    """The f32 workspace ``[nsplit, n_weights, m, n]`` and the zeroed tile
    counters of a bf16 launch whose K is split in ``nsplit`` ranges, or
    ``(None, None)`` for one range."""
    if nsplit <= 1:
        return None, None
    ws = torch.empty((nsplit, n_weights, m, n), dtype=torch.float32, device=dev)
    return ws, _build.split_counters(dev, tiles)
