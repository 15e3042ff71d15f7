"""Dense gated FFN (SwiGLU / GeGLU): a port of ``repro.models.ffn``'s
``init_mlp`` / ``mlp``.  ``fused=True`` runs the first half through the
fused gate/up kernel (:func:`repro_torch.kernels.ops.ffn_gateup`).  The
column-pruned FFN and MoE come with later slices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels import ops as kops
from .layers import init_linear, linear

__all__ = ["init_mlp", "mlp"]

Params = Dict[str, Any]


def init_mlp(
    gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.bfloat16,
    prune: Optional[Tuple[str, float]] = None,
) -> Params:
    if prune is not None:
        raise NotImplementedError("the column-pruned FFN comes with the PBCSR slice")
    return {
        "w_gate": init_linear(gen, d_model, d_ff, dtype=dtype),
        "w_up": init_linear(gen, d_model, d_ff, dtype=dtype),
        "w_down": init_linear(gen, d_ff, d_model, dtype=dtype),
    }


def mlp(
    p: Params,
    x: torch.Tensor,
    *,
    activation: str = "silu",
    mode: str = "dense",
    fused: bool = False,
) -> torch.Tensor:
    if fused and mode in ("dense", "masked") and "w" in p["w_gate"]:
        wg, wu = p["w_gate"]["w"], p["w_up"]["w"]
        if mode == "masked":
            wg = wg * p["w_gate"]["mask"].to(wg.dtype)
            wu = wu * p["w_up"]["mask"].to(wu.dtype)
        h = kops.ffn_gateup(x, wg, wu, activation=activation)
    else:
        g = linear(p["w_gate"], x, mode=mode, activation=activation)
        u = linear(p["w_up"], x, mode=mode)
        h = g * u
    return linear(p["w_down"], h, mode=mode)
