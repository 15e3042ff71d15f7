"""Fused gated-FFN first half ``act(x @ w_gate) * (x @ w_up)``: CUDA kernel +
plain version.

Replaces the TPU kernel ``repro/kernels/fused_ffn.py:ffn_gateup_kernel``
(wrapper ``ffn_gateup``).  ``ffn_gateup(x, w_gate, w_up, activation=...)``
takes 2-D ``x [M, K]`` and ``w_gate`` / ``w_up [K, F]`` of one element type
(f32 or bf16) and returns ``[M, F]`` in that type; both products accumulate
in f32 and the gate is applied before the one store.  The kernel
(``csrc/fused_ffn.cu``) streams each x tile once against both weights and
masks ragged M / K / F itself (the TPU wrapper pads to 128-blocks):

* bf16 with more than 8 rows (prefill): the tensor-core kernel of
  ``csrc/mma_gemm.cuh`` with two accumulators, on the default bf16 tile
  (``_build.bf16_default_tile``) and the K ranges ``_build.gemm_split``
  fixes from the shape;
* bf16 with at most 8 rows (decode): the weight-streaming split-K kernel
  (``csrc/skinny_bf16.cuh``, planned by ``_build.skinny_plan``);
* f32: a tiled FMA kernel, or with at most 8 rows the split-K kernel of
  ``csrc/skinny_gemm.cuh`` (``_build.skinny_plan_f32``).

Workspaces and tile counters of the split routes are this wrapper's.

What bounds it on an H100: the bytes of both weights (qwen2.5-3b: 90 MB a
layer, at least 27 us at 3.35 TB/s) at decode and at the M = 48 prefill.
Routing: a CPU tensor takes :func:`ffn_gateup_plain`, a CUDA tensor
launches the kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build
from .dense_matmul import split_buffers
from .ref import _ACT, ffn_gateup_ref

__all__ = ["ffn_gateup", "ffn_gateup_plain"]

#: kernel launches made by :func:`ffn_gateup` (CUDA route only)
launches = 0


def ffn_gateup_plain(
    x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, *, activation: str = "silu"
) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments)."""
    return ffn_gateup_ref(x, w_gate, w_up, activation=activation)


def ffn_gateup(
    x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, *, activation: str = "silu"
) -> torch.Tensor:
    """``act(x @ w_gate) * (x @ w_up)`` for 2-D operands; see the module doc."""
    global launches
    if x.dim() != 2 or w_gate.dim() != 2 or tuple(w_up.shape) != tuple(w_gate.shape) \
            or x.shape[1] != w_gate.shape[0]:
        raise ValueError(
            f"ffn_gateup: bad shapes x{tuple(x.shape)} w_gate{tuple(w_gate.shape)} "
            f"w_up{tuple(w_up.shape)}"
        )
    if activation not in _ACT or activation is None:
        raise ValueError(f"unknown activation {activation!r}")
    m, k = x.shape
    f = w_gate.shape[1]
    dtypes = {"x": x.dtype, "w_gate": x.dtype, "w_up": x.dtype} \
        if x.dtype in _build.FLOAT_CODES else None
    dev = _build.kernel_device("ffn_gateup", dtypes, x=x, w_gate=w_gate, w_up=w_up)
    if dev.type == "cpu":
        return ffn_gateup_plain(x, w_gate, w_up, activation=activation)
    out = torch.empty((m, f), dtype=x.dtype, device=dev)
    ws = counters = None
    kchunk = vec = 0
    tile = _build.bf16_default_tile(m, f)
    if x.dtype == torch.bfloat16:
        if m <= _build.SKINNY_MT and k > 0:
            vec = 8 if f % 8 == 0 and w_gate.data_ptr() % 16 == 0 \
                and w_up.data_ptr() % 16 == 0 else 1
            kchunk, nsplit, tiles = _build.skinny_plan(m, f, k, vec)
        else:
            kchunk, nsplit = _build.gemm_split(m, f, k)
            tiles = -(-m // tile[0]) * -(-f // tile[1])
        ws, counters = split_buffers(dev, nsplit, 2, m, f, tiles)
    elif m <= _build.SKINNY_MT and k > 0:
        align = 4 * x.element_size()
        vec = 4 if f % 4 == 0 and w_gate.data_ptr() % align == 0 \
            and w_up.data_ptr() % align == 0 else 1
        kchunk, nsplit, tiles = _build.skinny_plan_f32(m, f, k, vec)
        if nsplit > 1:
            ws = torch.empty((nsplit, 2, m, f), dtype=torch.float32, device=dev)
            counters = torch.zeros(tiles, dtype=torch.int32, device=dev)
    err = _build.lib().repro_ffn_gateup(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), out.data_ptr(), m, f, k,
        _build.activation_code(activation), _build.FLOAT_CODES[x.dtype],
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), kchunk, vec, *tile[:3],
        _build.stream_handle(),
    )
    _build.check(err, "ffn_gateup")
    launches += 1
    return out
