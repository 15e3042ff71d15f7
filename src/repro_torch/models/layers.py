"""Shared decoder layers (a port of the dense parts of ``repro.models.layers``;
params are nested dicts of tensors).

``linear`` runs the ``dense`` and ``masked`` execution modes as plain
``x @ w`` (the plan compiler's ``linear`` nodes are what run the
dense-matmul kernel).  The packed
modes of the JAX package (``bsr``, ``bsr_xla``, ``colpack``, ``colpack_xla``
and their ``init_pruned_linear``) come with the PBCSR slice and raise
``NotImplementedError`` here.

Initializers draw from an explicit ``torch.Generator`` on the generator's
device, in f32, and cast to the model dtype -- at full width the weights are
drawn on the card, never on the host.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..kernels.ref import _ACT

__all__ = [
    "init_linear",
    "linear",
    "init_rmsnorm",
    "rmsnorm",
    "init_embedding",
    "embed",
    "rope_freqs",
    "apply_rope",
]

Params = Dict[str, Any]

_PACKED_MODES = ("bsr", "bsr_xla", "colpack", "colpack_xla")


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def init_linear(
    gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
    dtype=torch.bfloat16, scale: Optional[float] = None,
) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p: Params = {"w": _normal(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def linear(
    p: Params,
    x: torch.Tensor,
    *,
    mode: str = "dense",
    activation: Optional[str] = None,
) -> torch.Tensor:
    """Apply a dense (or masked: ``w * mask``) linear layer."""
    if mode in ("dense", "masked"):
        w = p["w"]
        if mode == "masked":
            w = w * p["mask"].to(w.dtype)
        y = x @ w
        if "b" in p:
            y = y + p["b"]
        return _ACT[activation](y)
    if mode in _PACKED_MODES:
        raise NotImplementedError(f"linear mode {mode!r} comes with the PBCSR slice")
    raise ValueError(f"unknown linear mode {mode!r}")


def init_rmsnorm(d: int, dtype=torch.bfloat16, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 compute, cast back to x's type *before* the scale multiply."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype=torch.bfloat16) -> Params:
    return {"table": _normal(gen, (vocab, d), 0.02, dtype)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()]


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Split-half RoPE: ``x [..., S, H, dh]``, ``positions [..., S]``
    (broadcastable); f32 compute, cast back."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf = x.float()
    x1, x2 = xf[..., : dh // 2], xf[..., dh // 2 :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
