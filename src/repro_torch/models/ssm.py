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

Tensor parallelism (``sharding.on_mixer``, as the JAX package's rules cut
the block): each of the ranks of ``cut`` runs its share of the heads.
``in_proj`` is cut by columns in even chunks that do not fall on the
z | x | B | C | dt boundaries, so its output (activations, never the
weight) is gathered and each rank takes its heads' z, x and dt and the B
and C all heads share.  The gated RMSNorm's mean square is summed over the
ranks, ``out_proj`` (cut by rows, one rank's rows its heads' channels)
leaves a partial sum, and a decode step keeps the ``[B, H, N, P]`` state on
the rank's heads and the conv window on the channels of its cut, as the
JAX package's ``_cache_pspecs`` lays them out: the conv runs there and its
output is gathered.  With one rank (``WHOLE``) every step is the plain op.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import (causal_conv1d, conv1d_step, init_conv1d, init_linear, init_rmsnorm, linear,
                     linspace)
from .sharding import WHOLE, MixerCut

__all__ = ["init_mamba2", "mamba2_forward", "init_mamba2_cache", "mamba2_step", "TP"]

Params = Dict[str, Any]

#: ``sharding.on_mixer``'s layout of the block: ``in_proj`` cut by columns,
#: ``out_proj`` by rows, the decode state by heads and the conv window by
#: channels
TP = dict(cols=("in_proj",), rows=("out_proj",), cache_dims={"state": 1, "conv": 2})


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


def _share(cfg: ArchConfig, cut: MixerCut):
    """The rank's heads ``[h0, h0 + hl)`` and their channels ``[c0, c1)``
    of the inner width."""
    _, h, _, p_dim, _ = _dims(cfg)
    h0, hl = cut.split(h, f"{cfg.name}: the {h} Mamba-2 heads")
    return h0, hl, h0 * p_dim, (h0 + hl) * p_dim


def _proj(p: Params, cfg: ArchConfig, x: torch.Tensor, cut: MixerCut):
    """``in_proj`` on the rank's columns, gathered: ``(z, xbc, dt)``, z and
    dt of the rank's heads, xbc whole."""
    d_inner, h, n, _, g = _dims(cfg)
    h0, hl, c0, c1 = _share(cfg, cut)
    proj = cut.gather(linear(p["in_proj"], x), 2 * d_inner + 2 * g * n + h)
    z, xbc, dt = _split_proj(cfg, proj)
    return z[..., c0:c1], xbc, dt[..., h0:h0 + hl]


def _keep(cfg: ArchConfig, hl: int):
    """``keep(m)``: the columns of ``in_proj`` that rank ``m`` reads when
    each rank has ``hl`` heads (its heads' z, x and dt, and B and C)."""
    d_inner, _, n, p_dim, g = _dims(cfg)

    def keep(m: int):
        c0, c1 = m * hl * p_dim, (m + 1) * hl * p_dim
        dt0 = 2 * d_inner + 2 * g * n + m * hl
        return [*range(c0, c1), *range(d_inner + c0, d_inner + c1),
                *range(2 * d_inner, 2 * d_inner + 2 * g * n), *range(dt0, dt0 + hl)]

    return keep


def _move_weight(cfg: ArchConfig, x: torch.Tensor, cut: MixerCut) -> bool:
    """Whether the ``in_proj`` columns the rank reads are fewer to move than
    their share of its output (a long input: training, prefill)."""
    d_inner, h, n, _, g = _dims(cfg)
    read = 2 * d_inner // cut.n + 2 * g * n + h // cut.n
    return cut.n > 1 and x.shape[:-1].numel() * (2 * d_inner + 2 * g * n + h) > x.shape[-1] * read


def _proj_moved(p: Params, cfg: ArchConfig, x: torch.Tensor, cut: MixerCut):
    """``in_proj`` on the columns the rank reads, moved to it (``_keep``):
    ``(z, xbc, dt)`` of its heads, xbc its x channels and B and C."""
    d_inner, h, n, _, g = _dims(cfg)
    hl = h // cut.n
    w = cut.columns(p["in_proj"]["w"], 2 * d_inner + 2 * g * n + h, _keep(cfg, hl))
    c = hl * cfg.ssm.head_dim
    return torch.split(linear({"w": w}, x), [c, c + 2 * g * n, hl], dim=-1)


def _on_heads(t: torch.Tensor, dim: int, rep: int, h0: int, hl: int) -> torch.Tensor:
    """``t``'s groups along ``dim`` repeated to heads ``[h0, h0 + hl)``
    (``rep`` heads a group)."""
    g0, g1 = h0 // rep, (h0 + hl - 1) // rep + 1
    t = t.narrow(dim, g0, g1 - g0).repeat_interleave(rep, dim=dim)
    return t.narrow(dim, h0 - g0 * rep, hl)


def _conv_cols(p: Params, lo: int, hi: int) -> Params:
    return {"w": p["w"][:, lo:hi], "b": p["b"][lo:hi]}


def _gated_out(p: Params, cfg: ArchConfig, y: torch.Tensor, z: torch.Tensor, dtype,
               cut: MixerCut, c0: int, c1: int):
    """``out_proj(rmsnorm(y * silu(z)))`` on the rank's channels ``[c0,
    c1)``: the f32 mean square summed over the ranks, ``out_proj``'s partial
    sum returned."""
    d_inner = _dims(cfg)[0]
    yf = (y * F.silu(z.float()).to(dtype)).float()
    var = (yf * yf).mean(dim=-1, keepdim=True)
    if cut.n > 1:
        var = cut.sum(var * ((c1 - c0) / d_inner))
    y = (yf * torch.rsqrt(var + cfg.norm_eps)).to(dtype) * p["gate_norm"]["scale"][c0:c1]
    return linear(p["out_proj"], y)


def mamba2_forward(p: Params, cfg: ArchConfig, x: torch.Tensor, *, return_state: bool = False,
                   cut: MixerCut = WHOLE):
    """Full-sequence chunked SSD: ``x [B, S, D] -> [B, S, D]``; with
    ``return_state`` also the decode cache after the sequence (the final
    SSD state and the conv window): the chunked-prefill path for serving.
    With ``cut`` (``sharding.on_mixer``) on the rank's heads; the output is
    then a partial sum over the ranks, and the cache the rank's share."""
    d_inner, h, n, p_dim, g = _dims(cfg)
    h0, hl, c0, c1 = _share(cfg, cut)
    bsz, s, _ = x.shape
    L = min(cfg.ssm.chunk, s)
    while s % L:  # the largest chunk <= cfg's that divides S (exactness over speed)
        L -= 1
    nc = s // L
    rep = h // g

    # the conv runs on the rank's x channels and on the B and C every head
    # reads: ``mine``, their part of in_proj's output
    if _move_weight(cfg, x, cut) and not return_state:
        z, mine, dt = _proj_moved(p, cfg, x, cut)
    else:
        z, xbc_raw, dt = _proj(p, cfg, x, cut)
        mine = xbc_raw[..., c0:] if c1 == d_inner else torch.cat(
            [xbc_raw[..., c0:c1], xbc_raw[..., d_inner:]], dim=-1)
    conv = _conv_cols(p["conv"], c0, d_inner + 2 * g * n) if c1 == d_inner else {
        k: torch.cat([v[..., c0:c1], v[..., d_inner:]], dim=-1) for k, v in p["conv"].items()}
    xbc = F.silu(causal_conv1d(conv, mine).float()).to(x.dtype)
    xs, b_proj, c_proj = torch.split(xbc, [c1 - c0, g * n, g * n], dim=-1)
    xs = xs.reshape(bsz, nc, L, hl, p_dim).float()
    B = b_proj.reshape(bsz, nc, L, g, n).float()
    C = c_proj.reshape(bsz, nc, L, g, n).float()
    dt = F.softplus(dt.float() + p["dt_bias"][h0:h0 + hl]).reshape(bsz, nc, L, hl)
    dA = dt * -torch.exp(p["A_log"][h0:h0 + hl])  # log decay per step [B, nc, L, H]

    cum = torch.cumsum(dA, dim=2)
    # intra-chunk (the dual quadratic form):
    # Y[t] = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
    # (masked BEFORE the exp: the upper triangle's exponents are positive)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B, nc, T, S, H]
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                  torch.full((), -1e30, device=x.device)))
    cb = _on_heads(torch.einsum("bnlgd,bnsgd->bnlsg", C, B), -1, rep, h0, hl)
    att = cb * decay * dt[:, :, None, :, :]  # the weight on x_s
    y_intra = torch.einsum("bnlsh,bnshp->bnlhp", att, xs)

    # chunk states: S_c = sum_s exp(cum_last - cum_s) dt_s B_s x_s^T  [B, nc, H, N, P]
    last = cum[:, :, -1:, :]
    w = torch.exp(last - cum) * dt
    Bh = _on_heads(B, -2, rep, h0, hl)
    Ch = _on_heads(C, -2, rep, h0, hl)
    states = torch.einsum("bnlh,bnlhd,bnlhp->bnhdp", w, Bh, xs)

    # the inter-chunk recurrence over the nc chunks
    chunk_decay = torch.exp(last[:, :, 0, :])  # [B, nc, H]
    hstate = torch.zeros((bsz, hl, n, p_dim), dtype=torch.float32, device=x.device)
    y_inter = []
    for ci in range(nc):
        y_inter.append(torch.einsum("blhd,bhdp,blh->blhp", Ch[:, ci], hstate,
                                    torch.exp(cum[:, ci])))
        hstate = hstate * chunk_decay[:, ci][:, :, None, None] + states[:, ci]
    y = y_intra + torch.stack(y_inter, dim=1) + p["D"][None, None, None, h0:h0 + hl, None] * xs
    out = _gated_out(p, cfg, y.reshape(bsz, s, c1 - c0).to(x.dtype), z, x.dtype, cut, c0, c1)
    if not return_state:
        return out
    width = p["conv"]["w"].shape[0]
    lo, hi = cut.chunk(xbc_raw.shape[-1])
    pad = F.pad(xbc_raw[..., lo:hi], (0, 0, width - 1, 0))
    return out, {"state": hstate, "conv": pad[:, -(width - 1):, :]}


# ------------------------------ decode ------------------------------------- #


def init_mamba2_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16, device=None) -> Params:
    d_inner, h, n, p_dim, g = _dims(cfg)
    return {
        "state": torch.zeros((batch, h, n, p_dim), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, d_inner + 2 * g * n), dtype=dtype,
                            device=device),
    }


def mamba2_step(p: Params, cfg: ArchConfig, x_t: torch.Tensor, cache: Params,
                cut: MixerCut = WHOLE) -> Tuple[torch.Tensor, Params]:
    """One decode step: ``x_t [B, 1, D]``.  With ``cut``, on the rank's
    heads: ``cache["state"]`` holds them, ``cache["conv"]`` the channels of
    the rank's ``torch.chunk`` piece, and the output is a partial sum."""
    d_inner, h, n, p_dim, g = _dims(cfg)
    h0, hl, c0, c1 = _share(cfg, cut)
    bsz = x_t.shape[0]
    rep = h // g
    z, xbc, dt = _proj(p, cfg, x_t[:, 0], cut)
    lo, hi = cut.chunk(xbc.shape[-1])
    xbc, conv_win = conv1d_step(_conv_cols(p["conv"], lo, hi), cache["conv"], xbc[..., lo:hi])
    xbc = cut.gather(F.silu(xbc.float()).to(x_t.dtype), d_inner + 2 * g * n)
    xs, b_proj, c_proj = _split_xbc(cfg, xbc)
    xs = xs[..., c0:c1].reshape(bsz, hl, p_dim).float()
    Bh = _on_heads(b_proj.reshape(bsz, g, n).float(), 1, rep, h0, hl)
    Ch = _on_heads(c_proj.reshape(bsz, g, n).float(), 1, rep, h0, hl)
    dt = F.softplus(dt.float() + p["dt_bias"][h0:h0 + hl])  # [B, H]
    a = torch.exp(dt * -torch.exp(p["A_log"][h0:h0 + hl]))
    state = cache["state"] * a[:, :, None, None] + torch.einsum("bh,bhd,bhp->bhdp", dt, Bh, xs)
    y = torch.einsum("bhd,bhdp->bhp", Ch, state) + p["D"][None, h0:h0 + hl, None] * xs
    y = y.reshape(bsz, 1, c1 - c0).to(x_t.dtype)
    return (_gated_out(p, cfg, y, z[:, None, :], x_t.dtype, cut, c0, c1),
            {"state": state, "conv": conv_win})
