"""Shared decoder layers (a port of ``repro.models.layers``: linear, RMS
and layer norms, embedding, RoPE, and the causal depthwise conv1d of the
Mamba-2 and RG-LRU stems; params are nested dicts of tensors).

``linear`` is the integration point of the paper's technique: one layer
whose *execution mode* is chosen by the compiler layer --

* ``dense``       plain ``x @ w`` (the plan compiler's ``linear`` nodes are
                  what run the dense-matmul kernel),
* ``masked``      ``x @ (w * mask)``,
* ``bsr``         packed PBCSR blocks through the block-sparse kernel
                  (``ops.bsr_matmul``, honouring ``p["bands"]``),
* ``bsr_xla``     the same packed blocks in plain torch: a gather of the x
                  block-rows each output block-column needs, one einsum,
* ``colpack``     ColumnCompact gather + the smaller dense GEMM
                  (``ops.col_matmul``),
* ``colpack_xla`` the same in plain torch.

``init_pruned_linear`` draws packed params of those shapes with the JAX
package's deterministic stripe patterns.  Initializers draw from an
explicit ``torch.Generator`` on the generator's device, in f32, and cast to
the model dtype -- at full width the weights are drawn on the card, never
on the host.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels import ops as kops
from ..kernels.ref import _ACT
from .sharding import embedding

__all__ = [
    "init_linear",
    "linear",
    "init_pruned_linear",
    "linear_auto",
    "init_rmsnorm",
    "rmsnorm",
    "init_layernorm",
    "layernorm",
    "init_embedding",
    "embed",
    "rope_freqs",
    "apply_rope",
    "init_conv1d",
    "causal_conv1d",
    "conv1d_step",
]

Params = Dict[str, Any]


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)  # in place: one f32 transient, not two


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
    """Apply a (possibly pruned) linear layer; packed modes expect the packed
    params the compiler layer produces (values/kept or values/block_rows)."""
    if mode in ("dense", "masked"):
        w = p["w"]
        if mode == "masked":
            w = w * p["mask"].to(w.dtype)
        if x.dtype != w.dtype:  # jnp's promotion (e.g. f32 patch embeds, bf16 weights)
            t = torch.promote_types(x.dtype, w.dtype)
            x, w = x.to(t), w.to(t)
        # plain torch by design, not a fallback: the JAX package's
        # ``layers.linear`` defaults ``use_pallas`` to False, so its
        # forward-based path (``get_model`` / ``Engine``) is plain ``x @ w``
        # too; the plan compiler's linear nodes are what run the kernel
        y = x @ w
    elif mode == "bsr":
        return kops.bsr_matmul(
            x, p["values"], p["block_rows"], p.get("b"),
            activation=activation, bands=p.get("bands"),
        )
    elif mode == "bsr_xla":
        # gather the x block-rows each output block-column needs, one einsum
        # (pads clamp to block-row 0 against zero values, as in the JAX code)
        values, rows = p["values"], p["block_rows"]  # [Nb,S,bm,bn], [Nb,S]
        nb, _, bm, bn = values.shape
        lead = x.shape[:-1]
        xb = x.reshape(*lead, x.shape[-1] // bm, bm)
        xg = xb[..., rows.clamp(min=0).long(), :]  # [..., Nb, S, bm]
        y = torch.einsum("...jsb,jsbn->...jn", xg, values).reshape(*lead, nb * bn)
    elif mode == "colpack":
        return kops.col_matmul(x, p["values"], p["kept"], p.get("b"), activation=activation)
    elif mode == "colpack_xla":
        y = x.index_select(-1, p["kept"]) @ p["values"]
    else:
        raise ValueError(f"unknown linear mode {mode!r}")
    if "b" in p:
        y = y + p["b"]
    return _ACT[activation](y)


def linear_auto(p: Params, x: torch.Tensor, mode: str = "dense", activation=None):
    """``linear`` with the mode picked from the params: packed layers carry
    ``values`` (with ``block_rows``: ``bsr_xla``, else ``colpack_xla``), as
    the JAX package's ``_linear_auto`` dispatches."""
    if "values" in p:
        mode = "bsr_xla" if "block_rows" in p else "colpack_xla"
    return linear(p, x, mode=mode, activation=activation)


def init_pruned_linear(
    gen: torch.Generator,
    d_in: int,
    d_out: int,
    *,
    exec_mode: str,
    sparsity: float,
    bm: int = 128,
    bn: int = 128,
    bias: bool = False,
    dtype=torch.bfloat16,
) -> Params:
    """Packed-parameter init for the sparse execution modes: shapes are what
    the compiler emits; kept rows / block rows are the JAX package's
    deterministic stripes (``kept = arange * (d_in // k_kept)``; block-column
    j reads block-rows ``(j + i) % kb``)."""
    scale = 1.0 / math.sqrt(d_in)
    dev = gen.device
    if exec_mode in ("colpack", "colpack_xla"):
        k_kept = max(1, int(round(d_in * (1.0 - sparsity))))
        p: Params = {
            "values": _normal(gen, (k_kept, d_out), scale, dtype),
            "kept": torch.arange(k_kept, dtype=torch.int32, device=dev) * (d_in // k_kept),
        }
    elif exec_mode in ("bsr", "bsr_xla"):
        kb, nb = d_in // bm, d_out // bn
        s = max(1, int(round(kb * (1.0 - sparsity))))
        j = torch.arange(nb, dtype=torch.int32, device=dev)[:, None]
        i = torch.arange(s, dtype=torch.int32, device=dev)[None, :]
        p = {"values": _normal(gen, (nb, s, bm, bn), scale, dtype), "block_rows": (j + i) % kb}
    else:
        raise ValueError(exec_mode)
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=dev)
    return p


def linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """``num`` f32 points from ``start`` to ``stop`` by ``jnp.linspace``'s
    formula (``start * (1 - t) + stop * t``, ``t = i / (num - 1)`` in f32,
    the last point ``stop`` itself), for the init leaves drawn from a
    linspace: ``log(linspace(1, 16, 64))`` lands within one ulp of the JAX
    package's, ``torch.linspace``'s within three (it rounds 40 of the 64
    points the other way)."""
    if num < 2:
        return torch.full((num,), start, dtype=torch.float32, device=device)
    t = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    out = start * (1 - t) + stop * t
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32, device=device)])


def init_rmsnorm(d: int, dtype=torch.bfloat16, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 compute, cast back to x's type *before* the scale multiply."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


def init_layernorm(d: int, dtype=torch.bfloat16, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 statistics (biased variance), cast back to x's type before the
    scale and bias."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p["scale"] + p["bias"]


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype=torch.bfloat16) -> Params:
    return {"table": _normal(gen, (vocab, d), 0.02, dtype)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    # ``F.embedding``, not ``table[tokens]``: the same gather, and a backward
    # that sums each row's gradient in a fixed order (indexing's backward
    # accumulates in parallel, so two runs of one training step could differ);
    # a DTensor table is looked up vocab-parallel (``sharding.embedding``)
    return embedding(tokens.long(), p["table"])


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


# --------------------------------------------------------------------------- #
# causal depthwise conv1d (the Mamba-2 / Griffin stem)                         #
# --------------------------------------------------------------------------- #


def init_conv1d(gen: torch.Generator, channels: int, width: int, dtype=torch.bfloat16) -> Params:
    return {"w": _normal(gen, (width, channels), 1.0 / math.sqrt(width), dtype),
            "b": torch.zeros((channels,), dtype=dtype, device=gen.device)}


def causal_conv1d(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence: ``x [B, S, C] -> [B, S, C]``,
    the taps summed in f32 in order, cast back to x's type."""
    width = p["w"].shape[0]
    s = x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
    w = p["w"].float()
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + pad[:, i:i + s, :].float() * w[i]
    return (out + p["b"].float()).to(x.dtype)


def conv1d_step(p: Params, window: torch.Tensor, x_t: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step: ``window [B, width-1, C]`` past inputs, ``x_t [B, C]``;
    returns ``(y_t [B, C], new window)``."""
    t = torch.promote_types(window.dtype, x_t.dtype)
    full = torch.cat([window.to(t), x_t[:, None, :].to(t)], dim=1)  # [B, width, C]
    y = torch.einsum("bwc,wc->bc", full.float(), p["w"].float())
    y = (y + p["b"].float()).to(x_t.dtype)
    return y, full[:, 1:, :]
