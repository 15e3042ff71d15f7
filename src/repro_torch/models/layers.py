"""Shared decoder layers (a port of ``repro.models.layers``' linear,
norm, embedding and RoPE parts; params are nested dicts of tensors).

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
from typing import Any, Dict, Optional

import torch

from ..kernels import ops as kops
from ..kernels.ref import _ACT

__all__ = [
    "init_linear",
    "linear",
    "init_pruned_linear",
    "linear_auto",
    "init_rmsnorm",
    "rmsnorm",
    "init_embedding",
    "embed",
    "rope_freqs",
    "apply_rope",
]

Params = Dict[str, Any]


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
    """Apply a (possibly pruned) linear layer; packed modes expect the packed
    params the compiler layer produces (values/kept or values/block_rows)."""
    if mode in ("dense", "masked"):
        w = p["w"]
        if mode == "masked":
            w = w * p["mask"].to(w.dtype)
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
    # ``F.embedding``, not ``table[tokens]``: the same gather, and a backward
    # that sums each row's gradient in a fixed order (indexing's backward
    # accumulates in parallel, so two runs of one training step could differ)
    return torch.nn.functional.embedding(tokens.long(), p["table"])


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
