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

Tensor parallelism (``sharding.on_mixer``, as the JAX package's rules cut
the block): each of the ranks of ``cut`` runs its share of the W channels.
``gate_proj`` and ``in_proj`` run on its column cut, the conv and Lambda
(replicated) on its channels; ``W_r`` and ``W_i`` are cut by columns too
and read the conv's output whole, so that activation is gathered.  The
scan runs on the rank's channels, ``out_proj`` (cut by rows) leaves a
partial sum, and a decode step's ``h`` and conv window stay on the
channels the JAX package's ``_cache_pspecs`` gives the rank.  With one
rank (``WHOLE``) every step is the plain op.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.ref import _ACT
from .layers import causal_conv1d, conv1d_step, init_conv1d, init_linear, linear, linspace
from .sharding import WHOLE, MixerCut

__all__ = ["init_rglru_block", "rglru_block", "init_rglru_cache", "rglru_step", "linear_scan",
           "TP"]

Params = Dict[str, Any]

#: ``sharding.on_mixer``'s layout of the block: the input projections and
#: the gates cut by columns, ``out_proj`` by rows, ``h`` and the conv window
#: by channels
TP = dict(cols=("in_proj", "gate_proj", "w_r", "w_i"), rows=("out_proj",),
          cache_dims={"h": 1, "conv": 2})

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


def _share(cfg: ArchConfig, cut: MixerCut) -> Tuple[int, int]:
    """The rank's channels ``[c0, c1)``."""
    w = _width(cfg)
    c0, k = cut.split(w, f"{cfg.name}: the {w} RG-LRU channels")
    return c0, c0 + k


def _gates(p: Params, cfg: ArchConfig, u: torch.Tensor, cut: MixerCut, c0: int, c1: int):
    """``u [..., W_rank]`` (after the conv, the rank's channels) -> ``(a,
    gated input)`` on those channels, both f32; the gates read ``u``
    whole."""
    whole = cut.gather(u, _width(cfg))
    r = torch.sigmoid(linear(p["w_r"], whole).float())
    i = torch.sigmoid(linear(p["w_i"], whole).float())
    a = torch.exp(_C * r * F.logsigmoid(p["lam"][c0:c1]))
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u.float())
    return a, b


def _conv_cols(p: Params, c0: int, c1: int) -> Params:
    return {"w": p["w"][:, c0:c1], "b": p["b"][c0:c1]}


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


def rglru_block(p: Params, cfg: ArchConfig, x: torch.Tensor, *, return_state: bool = False,
                cut: MixerCut = WHOLE):
    """Full-sequence recurrent block, ``x [B, S, D]``; with ``return_state``
    also the decode cache (the final h and the conv window) for chunked
    prefill.  With ``cut`` (``sharding.on_mixer``) on the rank's channels;
    the output is then a partial sum over the ranks, the cache the rank's
    share."""
    c0, c1 = _share(cfg, cut)
    gate = _gelu(linear(p["gate_proj"], x).float())
    u_raw = linear(p["in_proj"], x)
    u = causal_conv1d(_conv_cols(p["conv"], c0, c1), u_raw)
    a, b = _gates(p, cfg, u, cut, c0, c1)  # [B, S, W] each, f32
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


def rglru_step(p: Params, cfg: ArchConfig, x_t: torch.Tensor, cache: Params,
               cut: MixerCut = WHOLE) -> Tuple[torch.Tensor, Params]:
    """One decode step: ``x_t [B, 1, D]``.  With ``cut``, on the rank's
    channels, which ``cache["h"]`` and ``cache["conv"]`` hold; the output is
    a partial sum."""
    c0, c1 = _share(cfg, cut)
    gate = _gelu(linear(p["gate_proj"], x_t[:, 0]).float())
    u, conv_win = conv1d_step(_conv_cols(p["conv"], c0, c1), cache["conv"],
                              linear(p["in_proj"], x_t[:, 0]))
    a, b = _gates(p, cfg, u, cut, c0, c1)
    h = a * cache["h"] + b
    return linear(p["out_proj"], (h * gate).to(x_t.dtype)[:, None, :]), {"h": h, "conv": conv_win}
