"""Gated FFN (SwiGLU / GeGLU): a port of ``repro.models.ffn``'s
``init_mlp`` / ``mlp``.  ``fused=True`` runs the first half through the
fused gate/up kernel (:func:`repro_torch.kernels.ops.ffn_gateup`).
``init_mlp(prune=(mode, sparsity))`` draws the paper's column-pruned FFN
(packed params), which ``mlp`` dispatches on (``layers.linear_auto``).
MoE comes with a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels import ops as kops
from .layers import init_linear, init_pruned_linear, linear_auto

__all__ = ["init_mlp", "mlp"]

Params = Dict[str, Any]


def init_mlp(
    gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.bfloat16,
    prune: Optional[Tuple[str, float]] = None,
) -> Params:
    def lin(d_in, d_out):
        if prune is None:
            return init_linear(gen, d_in, d_out, dtype=dtype)
        # the paper's FFN recipe: column pruning -> packed smaller GEMMs
        return init_pruned_linear(gen, d_in, d_out, exec_mode=prune[0], sparsity=prune[1],
                                  dtype=dtype)

    return {"w_gate": lin(d_model, d_ff), "w_up": lin(d_model, d_ff), "w_down": lin(d_ff, d_model)}


def mlp(
    p: Params,
    x: torch.Tensor,
    *,
    activation: str = "silu",
    mode: str = "dense",
    fused: bool = False,
) -> torch.Tensor:
    # ``fused`` defaults to False as in the JAX package's ``ffn.mlp``: the
    # forward-based path runs plain torch there and here (parity)
    if fused and mode in ("dense", "masked") and "w" in p["w_gate"]:
        wg, wu = p["w_gate"]["w"], p["w_up"]["w"]
        if mode == "masked":
            wg = wg * p["w_gate"]["mask"].to(wg.dtype)
            wu = wu * p["w_up"]["mask"].to(wu.dtype)
        h = kops.ffn_gateup(x, wg, wu, activation=activation)
    else:
        g = linear_auto(p["w_gate"], x, mode, activation=activation)
        u = linear_auto(p["w_up"], x, mode)
        h = g * u
    return linear_auto(p["w_down"], h, mode)
