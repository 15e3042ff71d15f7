"""Mamba-2 (SSD, state-space duality) block -- arXiv:2405.21060 (a port of
``repro.models.ssm``).

Chunked SSD: the sequence is cut into chunks of length L (the largest
divisor of S up to ``cfg.ssm.chunk``, so a prime S runs L = 1); within a
chunk the dual quadratic (attention-like) form runs as batched products,
across chunks a linear recurrence carries the ``[H, N, P]`` state.  Decode
is the plain recurrence with a constant state.

Shapes: x ``[B, S, D]``; inner width ``expand * D`` split into H heads of P =
``head_dim``; the B / C projections have N = ``d_state`` per group
(``n_groups`` shared across heads).  A gated RMSNorm and ``out_proj`` close
the block.  The decay, state and output math is f32 at the JAX package's
cast points; the projections run in the model dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import (causal_conv1d, conv1d_step, init_conv1d, init_linear, init_rmsnorm, linear,
                     linspace, rmsnorm)

__all__ = ["init_mamba2", "mamba2_forward", "init_mamba2_cache", "mamba2_step"]

Params = Dict[str, Any]


def _dims(cfg: ArchConfig):
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    return d_inner, d_inner // sc.head_dim, sc.d_state, sc.head_dim, sc.n_groups


def init_mamba2(gen: torch.Generator, cfg: ArchConfig, dtype=torch.bfloat16) -> Params:
    d_inner, h, n, _, g = _dims(cfg)
    dev = gen.device
    return {
        "in_proj": init_linear(gen, cfg.d_model, 2 * d_inner + 2 * g * n + h, dtype=dtype),
        "conv": init_conv1d(gen, d_inner + 2 * g * n, cfg.ssm.d_conv, dtype=dtype),
        "A_log": torch.log(linspace(1.0, 16.0, h, device=dev)),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "gate_norm": init_rmsnorm(d_inner, dtype, dev),
        "out_proj": init_linear(gen, d_inner, cfg.d_model, dtype=dtype),
    }


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    d_inner, h, n, _, g = _dims(cfg)
    return torch.split(proj, [d_inner, d_inner + 2 * g * n, h], dim=-1)  # z, xbc, dt


def _split_xbc(cfg: ArchConfig, xbc: torch.Tensor):
    d_inner, _, n, _, g = _dims(cfg)
    return torch.split(xbc, [d_inner, g * n, g * n], dim=-1)  # x, B, C


def _gated_out(p: Params, cfg: ArchConfig, y: torch.Tensor, z: torch.Tensor, dtype):
    y = rmsnorm(p["gate_norm"], y * F.silu(z.float()).to(dtype), cfg.norm_eps)
    return linear(p["out_proj"], y)


def mamba2_forward(p: Params, cfg: ArchConfig, x: torch.Tensor, *, return_state: bool = False):
    """Full-sequence chunked SSD: ``x [B, S, D] -> [B, S, D]``; with
    ``return_state`` also the decode cache after the sequence (the final
    SSD state and the conv window): the chunked-prefill path for serving."""
    d_inner, h, n, p_dim, g = _dims(cfg)
    bsz, s, _ = x.shape
    L = min(cfg.ssm.chunk, s)
    while s % L:  # the largest chunk <= cfg's that divides S (exactness over speed)
        L -= 1
    nc = s // L
    rep = h // g

    z, xbc_raw, dt = _split_proj(cfg, linear(p["in_proj"], x))
    xbc = F.silu(causal_conv1d(p["conv"], xbc_raw).float()).to(x.dtype)
    xs, b_proj, c_proj = _split_xbc(cfg, xbc)
    xs = xs.reshape(bsz, nc, L, h, p_dim).float()
    B = b_proj.reshape(bsz, nc, L, g, n).float()
    C = c_proj.reshape(bsz, nc, L, g, n).float()
    dt = F.softplus(dt.float() + p["dt_bias"]).reshape(bsz, nc, L, h)
    dA = dt * -torch.exp(p["A_log"])  # log decay per step [B, nc, L, H]

    cum = torch.cumsum(dA, dim=2)
    # intra-chunk (the dual quadratic form):
    # Y[t] = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
    # (masked BEFORE the exp: the upper triangle's exponents are positive)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B, nc, T, S, H]
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                  torch.full((), -1e30, device=x.device)))
    cb = torch.einsum("bnlgd,bnsgd->bnlsg", C, B).repeat_interleave(rep, dim=-1)
    att = cb * decay * dt[:, :, None, :, :]  # the weight on x_s
    y_intra = torch.einsum("bnlsh,bnshp->bnlhp", att, xs)

    # chunk states: S_c = sum_s exp(cum_last - cum_s) dt_s B_s x_s^T  [B, nc, H, N, P]
    last = cum[:, :, -1:, :]
    w = torch.exp(last - cum) * dt
    Bh = B.repeat_interleave(rep, dim=-2)
    Ch = C.repeat_interleave(rep, dim=-2)
    states = torch.einsum("bnlh,bnlhd,bnlhp->bnhdp", w, Bh, xs)

    # the inter-chunk recurrence over the nc chunks
    chunk_decay = torch.exp(last[:, :, 0, :])  # [B, nc, H]
    hstate = torch.zeros((bsz, h, n, p_dim), dtype=torch.float32, device=x.device)
    y_inter = []
    for ci in range(nc):
        y_inter.append(torch.einsum("blhd,bhdp,blh->blhp", Ch[:, ci], hstate,
                                    torch.exp(cum[:, ci])))
        hstate = hstate * chunk_decay[:, ci][:, :, None, None] + states[:, ci]
    y = y_intra + torch.stack(y_inter, dim=1) + p["D"][None, None, None, :, None] * xs
    out = _gated_out(p, cfg, y.reshape(bsz, s, d_inner).to(x.dtype), z, x.dtype)
    if not return_state:
        return out
    width = p["conv"]["w"].shape[0]
    pad = F.pad(xbc_raw, (0, 0, width - 1, 0))
    return out, {"state": hstate, "conv": pad[:, -(width - 1):, :]}


# ------------------------------ decode ------------------------------------- #


def init_mamba2_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16, device=None) -> Params:
    d_inner, h, n, p_dim, g = _dims(cfg)
    return {
        "state": torch.zeros((batch, h, n, p_dim), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, d_inner + 2 * g * n), dtype=dtype,
                            device=device),
    }


def mamba2_step(p: Params, cfg: ArchConfig, x_t: torch.Tensor, cache: Params
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step: ``x_t [B, 1, D]``."""
    d_inner, h, n, p_dim, g = _dims(cfg)
    bsz = x_t.shape[0]
    rep = h // g
    z, xbc, dt = _split_proj(cfg, linear(p["in_proj"], x_t[:, 0]))
    xbc, conv_win = conv1d_step(p["conv"], cache["conv"], xbc)
    xbc = F.silu(xbc.float()).to(x_t.dtype)
    xs, b_proj, c_proj = _split_xbc(cfg, xbc)
    xs = xs.reshape(bsz, h, p_dim).float()
    Bh = b_proj.reshape(bsz, g, n).float().repeat_interleave(rep, dim=1)
    Ch = c_proj.reshape(bsz, g, n).float().repeat_interleave(rep, dim=1)
    dt = F.softplus(dt.float() + p["dt_bias"])  # [B, H]
    a = torch.exp(dt * -torch.exp(p["A_log"]))
    state = cache["state"] * a[:, :, None, None] + torch.einsum("bh,bhd,bhp->bhdp", dt, Bh, xs)
    y = torch.einsum("bhd,bhdp->bhp", Ch, state) + p["D"][None, :, None] * xs
    y = y.reshape(bsz, 1, d_inner).to(x_t.dtype)
    return _gated_out(p, cfg, y, z[:, None, :], x_t.dtype), {"state": state, "conv": conv_win}
