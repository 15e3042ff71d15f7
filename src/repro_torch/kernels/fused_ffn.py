"""Fused gated-FFN first half ``act(x @ w_gate) * (x @ w_up)``: CUDA kernel +
plain version.

Replaces the TPU kernel ``repro/kernels/fused_ffn.py:ffn_gateup_kernel``
(wrapper ``ffn_gateup``).  ``ffn_gateup(x, w_gate, w_up, activation=...)``
takes 2-D ``x [M, K]`` and ``w_gate`` / ``w_up [K, F]`` of one element type
(f32 or bf16) and returns ``[M, F]`` in that type; both products accumulate
in f32 and the gate is applied before the one store.  The kernel
(``csrc/fused_ffn.cu``) streams each x tile once against both weights and
masks ragged M / K / F itself (the TPU wrapper pads to 128-blocks):

* bf16 where TMA addresses the operands (``_build.ffn_body``: x, both
  weights and out 16-byte aligned, K and F multiples of 8), prefill and
  decode alike: the Hopper body of ``csrc/wgmma_gemm.cuh`` with two weights
  (TMA brings one x box and a box of each weight into a ring slot, rows
  past M as zeros; ``wgmma`` m64n64k16 into a gate and an up accumulator
  on the same x descriptor), its tile and K ranges from
  ``_build.ffn_tma_plan`` (fixed by the shape), the ranges summed in a
  thread block cluster -- no workspace, no counters;
* any other bf16 launch (odd K or F, unaligned pointers): the tensor-core
  kernel of ``csrc/mma_gemm.cuh`` with two accumulators, on the default
  bf16 tile (``_build.bf16_default_tile``) and the K ranges
  ``_build.gemm_split`` fixes from the shape;
* f32 with more than 8 rows: the two-weight CUDA-core GEMM of
  ``csrc/ffn_f32.cuh`` on the tile ``_build.ffn_tile_f32`` picks by M, its K
  ranges (``_build.ffn_split_f32``, fixed by the shape) summed in a thread
  block cluster -- no workspace, no counters;
* f32 with at most 8 rows: that file's weight-streaming split-K kernel
  (``_build.skinny_plan_f32``), 16-byte weight loads where F % 4 == 0 and
  both weights are 16-byte aligned.

Workspaces of the split ``mma_gemm`` and f32 streaming routes are this
wrapper's (``torch.empty``); tile counters come from
``_build.split_counters``, which the kernels leave zeroed, so a call
launches one kernel and nothing else.

What bounds it on an H100 (qwen2.5-3b): the bytes of both weights at decode
(bf16 90 MB a layer, 27 us at 3.35 TB/s; f32 54 us) and at the bf16 M = 48
prefill -- one weight-bound problem, so one bf16 body serves both phases;
the f32 prefill's FMAs (4.3 GFLOP, 65 us at 67 TFLOP/s).
Routing: a CPU tensor takes :func:`ffn_gateup_plain`, a CUDA tensor
launches the kernel or raises.  ``launches`` counts kernel launches,
``route_launches`` the same launches by body.
"""

from __future__ import annotations

import torch

from . import _build
from .dense_matmul import split_buffers
from .ref import _ACT, ffn_gateup_ref

__all__ = ["ffn_gateup", "ffn_gateup_plain"]

#: kernel launches made by :func:`ffn_gateup` (CUDA route only)
launches = 0
#: the same launches by body: bf16 ``wgmma`` / ``mma_gemm``
#: (``_build.ffn_body``), f32 ``simt`` (M > 8) / ``stream`` (M <= 8)
route_launches = {"wgmma": 0, "mma_gemm": 0, "simt": 0, "stream": 0}


def ffn_gateup_plain(
    x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, *, activation: str = "silu"
) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments)."""
    return ffn_gateup_ref(x, w_gate, w_up, activation=activation)


def _aligned(f: int, vec: int, *ws: torch.Tensor) -> bool:
    """Rows of ``vec`` elements load as one 16-byte word: ``f`` a multiple
    of ``vec`` and every weight 16-byte aligned."""
    return f % vec == 0 and all(w.data_ptr() % 16 == 0 for w in ws)


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
    vec = 0
    if x.dtype == torch.bfloat16:
        aligned = all(t.data_ptr() % 16 == 0 for t in (x, w_gate, w_up, out))
        route = _build.ffn_body(f, k, aligned)
        if route == "wgmma":
            tile, kchunk, _ = _build.ffn_tma_plan(m, f, k)
        else:
            tile = _build.bf16_default_tile(m, f)
            kchunk, nsplit = _build.gemm_split(m, f, k)
            tiles = -(-m // tile[0]) * -(-f // tile[1])
            ws, counters = split_buffers(dev, nsplit, 2, m, f, tiles)
    elif m <= _build.SKINNY_MT and k > 0:
        route, tile = "stream", (0, 0, 0, 0)
        vec = 4 if _aligned(f, 4, w_gate, w_up) else 1
        kchunk, nsplit, tiles = _build.skinny_plan_f32(m, f, k, vec)
        ws, counters = split_buffers(dev, nsplit, 2, m, f, tiles)
    else:
        route, tile = "simt", (*_build.ffn_tile_f32(m), 0)
        kchunk, _ = _build.ffn_split_f32(m, f, k)
    err = _build.lib().repro_ffn_gateup(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), out.data_ptr(), m, f, k,
        _build.activation_code(activation), _build.FLOAT_CODES[x.dtype],
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), kchunk, vec, int(route == "wgmma"),
        *tile, _build.stream_handle(),
    )
    _build.check(err, "ffn_gateup")
    launches += 1
    route_launches[route] += 1
    return out
