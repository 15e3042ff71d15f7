"""GQA attention (a port of the dense-GQA part of ``repro.models.attention``):
projections with RoPE, full (materialized-score) softmax attention, prefill
with a populated KV cache, and the single-token decode step over it.

Layouts follow the JAX package: activations ``[B, S, D]``, per-head
tensors ``[B, S, H, dh]``, KV caches ``{"k", "v": [B, S_max, G, dh], "pos":
[B]}``.  Attention is causal over the full sequence (the JAX package's
``impl="full"``); MLA, cross-attention, sliding windows, prefix-LM masks and
the chunked (online-softmax) ``sdpa`` come with a later slice.  Under
``cfg.prune`` with a ``bsr`` execution mode the q and o projections are
block-pruned (packed params), and every projection dispatches on its params
(``layers.linear_auto``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from .layers import (
    apply_rope,
    init_linear,
    init_pruned_linear,
    init_rmsnorm,
    linear_auto,
    rmsnorm,
)

__all__ = [
    "sdpa",
    "init_gqa",
    "gqa_project_qkv",
    "gqa_attention",
    "gqa_prefill",
    "init_kv_cache",
    "gqa_decode_step",
]

Params = Dict[str, Any]

NEG_INF = -1e30


def _causal_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor) -> torch.Tensor:
    """Additive causal mask bias [Sq, Skv]: 0 where a query may attend (key
    position <= query position), -1e30 else."""
    ok = kv_pos[None, :] <= q_pos[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _sdpa_full(q, k, v, bias, scale):
    """q [B,Sq,H,dh], k [B,Skv,G,dh], v [B,Skv,G,dv]; H = G*rep.  bias [Sq,Skv]."""
    b, sq, h, dh = q.shape
    g = k.shape[2]
    dv = v.shape[-1]
    qg = q.reshape(b, sq, g, h // g, dh)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg.float(), k.float())
    logits = logits * scale + bias[None, None, None]
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", probs, v.float())
    return out.reshape(b, sq, h, dv).to(q.dtype)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Full causal softmax attention (the JAX package's ``impl="full"``)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _sdpa_full(q, k, v, _causal_bias(q_pos, kv_pos), scale)


def init_gqa(gen: torch.Generator, cfg: ArchConfig, dtype=torch.bfloat16) -> Params:
    dh = cfg.resolved_head_dim
    # the paper's attention recipe: block pruning of the q/o projections
    pruned = cfg.prune.enabled and cfg.prune.exec_mode in ("bsr_xla", "bsr")

    def lin(d_in, d_out, bias=False, prune=False):
        if prune:
            return init_pruned_linear(gen, d_in, d_out, exec_mode=cfg.prune.exec_mode,
                                      sparsity=cfg.prune.sparsity, bias=bias, dtype=dtype)
        return init_linear(gen, d_in, d_out, bias=bias, dtype=dtype)

    p: Params = {
        "w_q": lin(cfg.d_model, cfg.n_heads * dh, cfg.qkv_bias, pruned),
        "w_k": lin(cfg.d_model, cfg.n_kv_heads * dh, cfg.qkv_bias),
        "w_v": lin(cfg.d_model, cfg.n_kv_heads * dh, cfg.qkv_bias),
        "w_o": lin(cfg.n_heads * dh, cfg.d_model, prune=pruned),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(dh, dtype, gen.device)
        p["k_norm"] = init_rmsnorm(dh, dtype, gen.device)
    return p


def gqa_project_qkv(
    p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, *, mode: str = "dense"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    q = linear_auto(p["w_q"], x, mode).reshape(b, s, cfg.n_heads, dh)
    k = linear_auto(p["w_k"], x, mode).reshape(b, s, cfg.n_kv_heads, dh)
    v = linear_auto(p["w_v"], x, mode).reshape(b, s, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    mode: str = "dense",
) -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill); the mask uses
    row 0 of ``positions`` (every row shares the position grid)."""
    q, k, v = gqa_project_qkv(p, cfg, x, positions, mode=mode)
    pos1d = positions[0]
    out = sdpa(q, k, v, pos1d, pos1d)
    b, s = x.shape[:2]
    return linear_auto(p["w_o"], out.reshape(b, s, -1), mode)


def gqa_prefill(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    max_len: int,
    *,
    mode: str = "dense",
) -> Tuple[torch.Tensor, Params]:
    """Full-sequence attention + the KV cache it populates (serving prefill)."""
    b, s, _ = x.shape
    q, k, v = gqa_project_qkv(p, cfg, x, positions, mode=mode)
    pos1d = positions[0]
    out = sdpa(q, k, v, pos1d, pos1d)
    y = linear_auto(p["w_o"], out.reshape(b, s, -1), mode)
    pad = max(max_len - s, 0)
    kc = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))[:, :max_len]
    vc = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))[:, :max_len]
    cache = {"k": kc, "v": vc,
             "pos": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    return y, cache


def init_kv_cache(
    cfg: ArchConfig, batch: int, max_len: int, *, window: Optional[int] = None,
    dtype=torch.bfloat16, device=None,
) -> Params:
    """An empty KV cache of ``max_len`` slots a row, every row at position
    0.  ``pos`` is PER ROW, as in the JAX package: each slot of a
    continuous-batching batch advances on its own."""
    if window is not None:
        raise NotImplementedError(
            "sliding-window (ring-buffer) KV caches come with the hybrid archs (ROADMAP A7)")
    dh = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.n_kv_heads, dh)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def gqa_decode_step(
    p: Params,
    cfg: ArchConfig,
    x_t: torch.Tensor,  # [B, 1, D]
    cache: Params,
    *,
    mode: str = "dense",
) -> Tuple[torch.Tensor, Params]:
    """One decode step: write the new k/v at slot ``pos`` (clamped to the
    last slot), attend over slots ``<= pos``, advance ``pos``.  Returns new
    cache tensors (the inputs are not modified)."""
    b = x_t.shape[0]
    dh = cfg.resolved_head_dim
    pos = cache["pos"]
    q, k_new, v_new = gqa_project_qkv(p, cfg, x_t, pos[:, None], mode=mode)
    size = cache["k"].shape[1]
    slot = torch.clamp(pos, max=size - 1).long()
    rows = torch.arange(b, device=x_t.device)
    k = cache["k"].clone()
    v = cache["v"].clone()
    k[rows, slot] = k_new[:, 0].to(k.dtype)
    v[rows, slot] = v_new[:, 0].to(v.dtype)
    idx = torch.arange(size, dtype=torch.int32, device=x_t.device)
    valid = idx[None, :] <= pos[:, None]
    g = cfg.n_kv_heads
    qg = q.reshape(b, 1, g, cfg.n_heads // g, dh).float()
    logits = torch.einsum("bsgrd,btgd->bgrst", qg, k.float()) / math.sqrt(dh)
    logits = torch.where(valid[:, None, None, None, :], logits,
                         torch.full((), NEG_INF, device=x_t.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", probs, v.float())
    out = out.reshape(b, 1, cfg.n_heads * dh).to(x_t.dtype)
    y = linear_auto(p["w_o"], out, mode)
    return y, {"k": k, "v": v, "pos": pos + 1}
