"""RG-LRU recurrent block (Griffin, arXiv:2402.19427) for RecurrentGemma (a
port of ``repro.models.rglru``).

The block: x -> (linear branch, gate branch); the linear branch runs conv1d
-> RG-LRU; output = out_proj(rglru_out * gelu(gate)).

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_r x_t)          recurrence gate
    i_t = sigmoid(W_i x_t)          input gate
    a_t = a^(c * r_t)               with a = sigmoid(Lambda), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full-sequence form runs the affine maps ``h -> a h + b`` through a
log-depth doubling scan (Hillis-Steele: ceil(log2 S) rounds of whole-tensor
ops), where the JAX package runs ``jax.lax.associative_scan``: the same
combine, composed in another order, so the two agree to f32 rounding, not
bit for bit.  Decode is the plain recurrence with a ``[B, W]`` f32 state.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.ref import _ACT
from .layers import causal_conv1d, conv1d_step, init_conv1d, init_linear, linear, linspace
from .sharding import elementwise

__all__ = ["init_rglru_block", "rglru_block", "init_rglru_cache", "rglru_step", "linear_scan"]

Params = Dict[str, Any]

_C = 8.0  # Griffin's fixed exponent scale
_gelu = _ACT["gelu"]  # tanh GeLU, jax.nn.gelu's default


def _width(cfg: ArchConfig) -> int:
    return cfg.recurrent.lru_width or cfg.d_model


def init_rglru_block(gen: torch.Generator, cfg: ArchConfig, dtype=torch.bfloat16) -> Params:
    w = _width(cfg)
    # Lambda such that a = sigmoid(Lambda)^c spans (0.9, 0.999)
    a_c = linspace(0.9, 0.999, w, device=gen.device) ** (1.0 / _C)
    return {
        "in_proj": init_linear(gen, cfg.d_model, w, dtype=dtype),
        "gate_proj": init_linear(gen, cfg.d_model, w, dtype=dtype),
        "conv": init_conv1d(gen, w, cfg.recurrent.d_conv, dtype=dtype),
        "w_r": init_linear(gen, w, w, dtype=dtype),
        "w_i": init_linear(gen, w, w, dtype=dtype),
        "lam": torch.log(a_c / (1 - a_c)),
        "out_proj": init_linear(gen, w, cfg.d_model, dtype=dtype),
    }


def _gates(p: Params, x: torch.Tensor):
    """``x [..., W]`` (after the conv) -> ``(a, gated input)``, both f32."""
    r = torch.sigmoid(linear(p["w_r"], x).float())
    i = torch.sigmoid(linear(p["w_i"], x).float())
    a = torch.exp(_C * r * elementwise(F.logsigmoid, p["lam"]))
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x.float())
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` from ``h_{-1} = 0`` along ``dim``, as a
    log-depth doubling scan: round k composes each position with the one
    ``2^k`` back (``(a_l, b_l), (a_r, b_r) -> (a_l a_r, a_r b_l + b_r)``)."""
    a, b = a.movedim(dim, 0), b.movedim(dim, 0)
    s = a.shape[0]
    for k in range(math.ceil(math.log2(s)) if s > 1 else 0):
        off = 1 << k
        b = torch.cat([b[:off], a[off:] * b[:-off] + b[off:]])
        a = torch.cat([a[:off], a[:-off] * a[off:]])
    return b.movedim(0, dim)


def rglru_block(p: Params, cfg: ArchConfig, x: torch.Tensor, *, return_state: bool = False):
    """Full-sequence recurrent block, ``x [B, S, D]``; with ``return_state``
    also the decode cache (the final h and the conv window) for chunked
    prefill."""
    gate = _gelu(linear(p["gate_proj"], x).float())
    u_raw = linear(p["in_proj"], x)
    a, b = _gates(p, causal_conv1d(p["conv"], u_raw))  # [B, S, W] each, f32
    h = linear_scan(a, b, dim=1)
    out = linear(p["out_proj"], (h * gate).to(x.dtype))
    if not return_state:
        return out
    width = p["conv"]["w"].shape[0]
    pad = F.pad(u_raw, (0, 0, width - 1, 0))
    return out, {"h": h[:, -1], "conv": pad[:, -(width - 1):, :]}


def init_rglru_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16, device=None) -> Params:
    w = _width(cfg)
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.recurrent.d_conv - 1, w), dtype=dtype, device=device),
    }


def rglru_step(p: Params, cfg: ArchConfig, x_t: torch.Tensor, cache: Params
               ) -> Tuple[torch.Tensor, Params]:
    """One decode step: ``x_t [B, 1, D]``."""
    gate = _gelu(linear(p["gate_proj"], x_t[:, 0]).float())
    u, conv_win = conv1d_step(p["conv"], cache["conv"], linear(p["in_proj"], x_t[:, 0]))
    a, b = _gates(p, u)
    h = a * cache["h"] + b
    return linear(p["out_proj"], (h * gate).to(x_t.dtype)[:, None, :]), {"h": h, "conv": conv_win}
