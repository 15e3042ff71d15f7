"""Attention (a port of ``repro.models.attention``): GQA / MQA (+qk_norm,
+bias) with sliding windows and prefix-LM masks, full (materialized-score)
and chunked (online-softmax) ``sdpa``, KV caches (full, ring-buffer and
MLA's compressed one) with single-token decode steps, DeepSeek's MLA and
Whisper's cross-attention.

Layouts follow the JAX package: activations ``[B, S, D]``, per-head
tensors ``[B, S, H, dh]``, KV caches ``{"k", "v": [B, S_max, G, dh], "pos":
[B]}`` (``pos`` per row), MLA caches ``{"c_kv": [B, S_max, r], "k_rope":
[B, S_max, dr], "pos": [B]}``.  Under ``cfg.prune`` with a ``bsr``
execution mode the GQA q and o projections are block-pruned (packed
params), and every GQA projection dispatches on its params
(``layers.linear_auto``).  Everything here is plain torch, as the JAX
package's forward-based path is plain jnp: the decoder plans
(``transformer_graph``) are what run the kernels.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from .layers import (
    apply_rope,
    init_linear,
    init_pruned_linear,
    init_rmsnorm,
    linear,
    linear_auto,
    rmsnorm,
)
from .sharding import (attention_on_shards, is_dtensor, merge_last, on_cache, on_heads,
                       on_sequence, placed_like, split_last)

__all__ = [
    "sdpa",
    "init_gqa",
    "gqa_project_qkv",
    "gqa_attention",
    "gqa_prefill",
    "init_kv_cache",
    "gqa_decode_step",
    "init_mla",
    "mla_attention",
    "mla_prefill",
    "init_mla_cache",
    "mla_decode_step",
    "init_cross_attention",
    "cross_attention_kv",
    "cross_attention",
]

Params = Dict[str, Any]

NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# masks                                                                        #
# --------------------------------------------------------------------------- #


def _mask_bias(
    q_pos: torch.Tensor,  # [Sq] absolute positions of the queries
    kv_pos: torch.Tensor,  # [Skv]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """Additive mask bias [Sq, Skv] (f32): 0 where a query may attend, -1e30
    else.  Causal: key position <= query position, bidirectional inside a
    prefix of ``prefix_len`` positions (prefix-LM); ``window`` keeps keys
    less than ``window`` positions back."""
    qi = q_pos[:, None]
    kj = kv_pos[None, :]
    ok = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok = kj <= qi
        if prefix_len > 0:
            ok = ok | ((qi < prefix_len) & (kj < prefix_len))
    if window is not None:
        ok = ok & (qi - kj < window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


# --------------------------------------------------------------------------- #
# core attention                                                               #
# --------------------------------------------------------------------------- #


def _sdpa_full(q, k, v, bias, scale):
    """q [B,Sq,H,dh], k [B,Skv,G,dh], v [B,Skv,G,dv]; H = G*rep (dv may differ
    from dh, e.g. MLA's rope-extended queries).  bias [Sq,Skv]."""
    b, sq, h, dh = q.shape
    g = k.shape[2]
    dv = v.shape[-1]
    qg = q.reshape(b, sq, g, h // g, dh)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg.float(), k.float())
    logits = logits * scale + bias[None, None, None]
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", probs, v.float())
    return out.reshape(b, sq, h, dv).to(q.dtype)


def _sdpa_chunked(q, k, v, q_pos, kv_pos, scale, *, causal: bool, window: Optional[int],
                  prefix_len: int, chunk: int = 1024):
    """Online softmax over KV chunks of ``chunk`` keys (the flash-attention
    recurrence in plain torch, f32 running max / sum / accumulator)."""
    b, sq, h, dh = q.shape
    g = k.shape[2]
    dv = v.shape[-1]
    rep = h // g
    skv = k.shape[1]
    qg = q.reshape(b, sq, g, rep, dh).float()
    m = torch.full((b, g, rep, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, g, rep, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, g, rep, dv), dtype=torch.float32, device=q.device)
    for lo in range(0, skv, chunk):
        hi = min(lo + chunk, skv)
        bias = _mask_bias(q_pos, kv_pos[lo:hi], causal=causal, window=window,
                          prefix_len=prefix_len)
        logits = torch.einsum("bsgrd,btgd->bgrst", qg, k[:, lo:hi].float()) * scale
        logits = logits + bias[None, None, None]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pr = torch.exp(logits - m_new[..., None])
        l = l * alpha + pr.sum(dim=-1)
        acc = acc * alpha.movedim(3, 1)[..., None] + torch.einsum(
            "bgrst,btgd->bsgrd", pr, v[:, lo:hi].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30).movedim(3, 1)[..., None]
    return out.reshape(b, sq, h, dv).to(q.dtype)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,
    impl: str = "auto",
    chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention, ``impl`` "full" (materialized scores) or "chunked"
    (online softmax); "auto" is chunked when there are more than 8192 keys
    and more than one query, as in the JAX package."""
    if is_dtensor(q) or is_dtensor(k):  # on a mesh: each rank's batch rows and heads
        q_pos, kv_pos = (t.full_tensor() if is_dtensor(t) else t for t in (q_pos, kv_pos))
        return attention_on_shards(functools.partial(
            sdpa, q_pos=q_pos, kv_pos=kv_pos, causal=causal, window=window,
            prefix_len=prefix_len, impl=impl, chunk=chunk, scale=scale), q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if impl == "auto":
        impl = "chunked" if k.shape[1] > 8192 and q.shape[1] > 1 else "full"
    if impl == "full":
        bias = _mask_bias(q_pos, kv_pos, causal=causal, window=window, prefix_len=prefix_len)
        return _sdpa_full(q, k, v, bias, scale)
    if impl != "chunked":
        raise ValueError(f"unknown sdpa impl {impl!r}")
    return _sdpa_chunked(q, k, v, q_pos, kv_pos, scale, causal=causal, window=window,
                         prefix_len=prefix_len, chunk=chunk)


# --------------------------------------------------------------------------- #
# GQA attention block                                                          #
# --------------------------------------------------------------------------- #


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
    dh = cfg.resolved_head_dim
    q = split_last(linear_auto(p["w_q"], x, mode), cfg.n_heads, dh)
    k = split_last(linear_auto(p["w_k"], x, mode), cfg.n_kv_heads, dh)
    v = split_last(linear_auto(p["w_v"], x, mode), cfg.n_kv_heads, dh)
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
    window: Optional[int] = None,
    prefix_len: int = 0,
    causal: bool = True,
    impl: str = "auto",
    mode: str = "dense",
    chunk: int = 1024,
) -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill); the mask uses
    row 0 of ``positions`` (every row shares the position grid)."""
    q, k, v = gqa_project_qkv(p, cfg, x, positions, mode=mode)
    pos1d = positions[0]
    out = sdpa(q, k, v, pos1d, pos1d, causal=causal, window=window, prefix_len=prefix_len,
               impl=impl, chunk=chunk)
    return linear_auto(p["w_o"], merge_last(out), mode)


# ----------------------------- KV cache ------------------------------------ #


def init_kv_cache(
    cfg: ArchConfig, batch: int, max_len: int, *, window: Optional[int] = None,
    dtype=torch.bfloat16, device=None,
) -> Params:
    """An empty KV cache, every row at position 0: ``max_len`` slots a row,
    or ``min(window, max_len)`` slots used as a ring buffer with a window.
    ``pos`` is PER ROW, as in the JAX package: each slot of a
    continuous-batching batch advances on its own."""
    dh = cfg.resolved_head_dim
    size = min(window, max_len) if window else max_len
    shape = (batch, size, cfg.n_kv_heads, dh)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _write_slot(t: torch.Tensor, local: torch.Tensor, new: torch.Tensor,
                fits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``t [B, n, ...]`` with row b's ``new[b]`` at slot ``local[b]`` where
    that slot is one of ``t``'s ``n`` (on a mesh: the rank whose slice of
    the cache holds it) and ``fits[b]`` allows; elsewhere the row rewrites a
    slot with what is already there (no host sync).  Out of place (a new
    cache tensor; the input is not modified)."""
    b, n = t.shape[:2]
    if n == 0:
        return t
    keep = (local >= 0) & (local < n)
    if fits is not None:
        keep = keep & fits
    at = (torch.arange(b, device=t.device), local.clamp(0, n - 1).long())
    keep = keep.reshape(b, *[1] * (new.ndim - 1))
    return torch.index_put(t, at, torch.where(keep, new.to(t.dtype), t[at]))


def _partials(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The max of ``logits`` over its last dim and the sum of
    ``exp(logit - max)``: what a split-K combine weighs a slice's
    normalized output by."""
    m = logits.amax(dim=-1)
    return m, torch.exp(logits - m[..., None]).sum(dim=-1)


def gqa_decode_step(
    p: Params,
    cfg: ArchConfig,
    x_t: torch.Tensor,  # [B, 1, D]
    cache: Params,
    *,
    window: Optional[int] = None,
    mode: str = "dense",
) -> Tuple[torch.Tensor, Params]:
    """One decode step: write the new k/v at slot ``pos`` (clamped to the
    last slot; ``pos % size`` in a ring buffer when ``window`` is set),
    attend over the valid slots, advance ``pos``.  Returns new cache tensors
    (the inputs are not modified).  On a mesh each rank attends over its
    own slots of the cache (``sharding.on_cache``), which keeps its
    placements."""
    dh = cfg.resolved_head_dim
    g = cfg.n_kv_heads
    rep = cfg.n_heads // g
    pos = cache["pos"]
    q, k_new, v_new = gqa_project_qkv(p, cfg, x_t, pos[:, None], mode=mode)
    size = cache["k"].shape[1]

    def attend(rows, kv, lo, partial):  # the batch rows' slots [lo, lo + n)
        q, k_new, v_new, pos = rows
        b, n = q.shape[0], kv["k"].shape[1]
        slot = pos % size if window is not None else torch.clamp(pos, max=size - 1)
        k = _write_slot(kv["k"], slot - lo, k_new[:, 0])
        v = _write_slot(kv["v"], slot - lo, v_new[:, 0])
        idx = lo + torch.arange(n, dtype=torch.int32, device=q.device)
        if window is None:
            valid = idx[None, :] <= pos[:, None]
        else:
            # absolute positions of the ring's slots, per row
            wraps = torch.div(pos, size, rounding_mode="floor")[:, None]
            kv_pos = torch.where(idx[None, :] <= slot[:, None], wraps * size + idx[None, :],
                                 (wraps - 1) * size + idx[None, :])
            valid = (kv_pos >= 0) & (kv_pos <= pos[:, None]) & (
                pos[:, None] - kv_pos < (window or size))
        qg = q.reshape(b, 1, g, rep, dh).float()
        logits = torch.einsum("bsgrd,btgd->bgrst", qg, k.float()) / math.sqrt(dh)
        logits = torch.where(valid[:, None, None, None, :], logits,
                             torch.full((), NEG_INF, device=q.device))
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bgrst,btgd->bsgrd", probs, v.float()).reshape(b, 1, g * rep, dh)
        if not partial:
            return out, {"k": k, "v": v}
        m, l = (t.reshape(b, 1, g * rep) for t in _partials(logits[..., 0, :]))
        return out, m, l, {"k": k, "v": v}

    out, kv = on_cache(attend, (q, k_new, v_new, pos), {"k": cache["k"], "v": cache["v"]})
    y = linear_auto(p["w_o"], merge_last(out).to(x_t.dtype), mode)
    return y, {**kv, "pos": pos + 1}


def gqa_prefill(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    max_len: int,
    *,
    window: Optional[int] = None,
    prefix_len: int = 0,
    impl: str = "auto",
    mode: str = "dense",
) -> Tuple[torch.Tensor, Params]:
    """Full-sequence attention + the KV cache it populates (serving prefill);
    with a window shorter than the sequence the cache is in ring layout (slot
    i holds the largest position p < S with p % size == i)."""
    b, s, _ = x.shape
    q, k, v = gqa_project_qkv(p, cfg, x, positions, mode=mode)
    pos1d = positions[0]
    out = sdpa(q, k, v, pos1d, pos1d, causal=True, window=window, prefix_len=prefix_len,
               impl=impl)
    y = linear_auto(p["w_o"], merge_last(out), mode)
    size = min(window, max_len) if window else max_len

    def slots(t):  # the prompt's k or v -> the cache's slots
        if window is None or s <= size:
            return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, max(size - s, 0)))[:, :size]
        idx = torch.arange(size, device=t.device)
        return t[:, idx + size * torch.div(s - 1 - idx, size, rounding_mode="floor")]

    cache = {"k": on_sequence(slots, k, size), "v": on_sequence(slots, v, size),
             "pos": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    return y, cache


# --------------------------------------------------------------------------- #
# MLA (DeepSeek-V2 multi-head latent attention)                                #
# --------------------------------------------------------------------------- #


def init_mla(gen: torch.Generator, cfg: ArchConfig, dtype=torch.bfloat16) -> Params:
    dh, r, dr, h = cfg.resolved_head_dim, cfg.kv_lora_rank, cfg.rope_head_dim, cfg.n_heads
    p: Params = {}
    if cfg.q_lora_rank:
        p["w_dq"] = init_linear(gen, cfg.d_model, cfg.q_lora_rank, dtype=dtype)
        p["q_norm"] = init_rmsnorm(cfg.q_lora_rank, dtype, gen.device)
        p["w_uq"] = init_linear(gen, cfg.q_lora_rank, h * (dh + dr), dtype=dtype)
    else:
        p["w_q"] = init_linear(gen, cfg.d_model, h * (dh + dr), dtype=dtype)
    p["w_dkv"] = init_linear(gen, cfg.d_model, r, dtype=dtype)
    p["kv_norm"] = init_rmsnorm(r, dtype, gen.device)
    p["w_kr"] = init_linear(gen, cfg.d_model, dr, dtype=dtype)  # the shared rope key
    p["w_uk"] = init_linear(gen, r, h * dh, dtype=dtype)
    p["w_uv"] = init_linear(gen, r, h * dh, dtype=dtype)
    p["w_o"] = init_linear(gen, h * dh, cfg.d_model, dtype=dtype)
    return p


def _mla_q(p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    b, s, _ = x.shape
    dh, dr = cfg.resolved_head_dim, cfg.rope_head_dim
    if cfg.q_lora_rank:
        q = linear(p["w_uq"], rmsnorm(p["q_norm"], linear(p["w_dq"], x), cfg.norm_eps))
    else:
        q = linear(p["w_q"], x)
    q = split_last(q, cfg.n_heads, dh + dr)
    return q[..., :dh], apply_rope(q[..., dh:], positions, cfg.rope_theta)


def _mla_latent(p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """The compressed KV ``c_kv [B, S, r]`` and the shared rope key
    ``k_rope [B, S, 1, dr]``."""
    b, s, _ = x.shape
    c_kv = rmsnorm(p["kv_norm"], linear(p["w_dkv"], x), cfg.norm_eps)
    k_rope = apply_rope(linear(p["w_kr"], x).reshape(b, s, 1, cfg.rope_head_dim), positions,
                        cfg.rope_theta)
    return c_kv, k_rope


def mla_attention(p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                  *, impl: str = "auto") -> torch.Tensor:
    """Full-sequence MLA (train / prefill): K / V decompressed per head."""
    b, s, _ = x.shape
    dh, dr, h = cfg.resolved_head_dim, cfg.rope_head_dim, cfg.n_heads
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    k_nope = split_last(linear(p["w_uk"], c_kv), h, dh)
    v = split_last(linear(p["w_uv"], c_kv), h, dh)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    pos1d = positions[0]
    out = sdpa(q, k, v, pos1d, pos1d, causal=True, impl=impl, scale=1.0 / math.sqrt(dh + dr))
    return linear(p["w_o"], merge_last(out))


def mla_prefill(p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                max_len: int, *, impl: str = "auto") -> Tuple[torch.Tensor, Params]:
    """Full-sequence MLA + the compressed cache it populates."""
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"mla_prefill: {s} positions do not fit a cache of {max_len}")
    y = mla_attention(p, cfg, x, positions, impl=impl)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)

    def slots(t):  # the prompt's latents -> the cache's slots
        return torch.nn.functional.pad(t, (0, 0, 0, max_len - s))

    cache = {
        "c_kv": on_sequence(slots, c_kv, max_len),
        "k_rope": on_sequence(slots, merge_last(k_rope), max_len),
        "pos": torch.full((b,), s, dtype=torch.int32, device=x.device),
    }
    return y, cache


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> Params:
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.rope_head_dim), dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def mla_decode_step(p: Params, cfg: ArchConfig, x_t: torch.Tensor, cache: Params
                    ) -> Tuple[torch.Tensor, Params]:
    """Absorbed decode: the queries move into the latent space, the cache
    stays r-wide.

    score_h(t) = q_nope_h^T W_uk_h c_t + q_rope_h^T k_rope_t
    out_h      = (sum_t p_t c_t) W_uv_h

    A row at ``pos >= max_len`` writes nothing (JAX drops an out-of-range
    scatter) and attends over the whole cache.  On a mesh the absorptions
    run on each rank's heads (``sharding.on_heads``) and the attention on
    each rank's slots of the cache (``sharding.on_cache``), which keeps its
    placements."""
    dh, dr, r = cfg.resolved_head_dim, cfg.rope_head_dim, cfg.kv_lora_rank
    pos = cache["pos"]
    q_nope, q_rope = _mla_q(p, cfg, x_t, pos[:, None])  # [B,1,H,dh], [B,1,H,dr]
    c_new, kr_new = _mla_latent(p, cfg, x_t, pos[:, None])  # [B,1,r], [B,1,1,dr]
    size = cache["c_kv"].shape[1]
    q_r = on_heads(lambda q, w: torch.einsum("bhd,rhd->bhr", q[:, 0].float(),
                                             w.reshape(r, -1, dh).float())[:, None],
                   q_nope, p["w_uk"]["w"])  # [B,1,H,r]

    def attend(rows, latent, lo, partial):  # the batch rows' slots [lo, lo + n)
        q_r, q_rope, c_new, kr_new, pos = rows
        b, n = q_r.shape[0], latent["c_kv"].shape[1]
        fits = pos < size  # the drop, without a host sync
        c_kv = _write_slot(latent["c_kv"], pos - lo, c_new[:, 0], fits)
        k_rope = _write_slot(latent["k_rope"], pos - lo, kr_new.reshape(b, dr), fits)
        s_nope = torch.einsum("bhr,btr->bht", q_r[:, 0], c_kv.float())
        s_rope = torch.einsum("bhd,btd->bht", q_rope[:, 0].float(), k_rope.float())
        valid = lo + torch.arange(n, device=q_r.device)[None, :] <= pos[:, None]
        logits = (s_nope + s_rope) / math.sqrt(dh + dr)
        logits = torch.where(valid[:, None, :], logits,
                             torch.full((), NEG_INF, device=q_r.device))
        probs = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bht,btr->bhr", probs, c_kv.float())[:, None]
        new = {"c_kv": c_kv, "k_rope": k_rope}
        if not partial:
            return ctx, new
        m, l = _partials(logits)
        return ctx, m[:, None], l[:, None], new

    ctx, latent = on_cache(attend, (q_r, q_rope, c_new, kr_new, pos),
                           {"c_kv": cache["c_kv"], "k_rope": cache["k_rope"]})
    out = on_heads(lambda c, w: torch.einsum("bhr,rhd->bhd", c[:, 0],
                                             w.reshape(r, -1, dh).float())[:, None],
                   placed_like(ctx, q_r), p["w_uv"]["w"])  # [B,1,H,dh], on q's heads
    y = linear(p["w_o"], merge_last(out).to(x_t.dtype))
    return y, {**latent, "pos": pos + 1}


# --------------------------------------------------------------------------- #
# cross attention (the Whisper decoder)                                        #
# --------------------------------------------------------------------------- #


def init_cross_attention(gen: torch.Generator, cfg: ArchConfig, dtype=torch.bfloat16) -> Params:
    dh = cfg.resolved_head_dim
    return {
        "w_q": init_linear(gen, cfg.d_model, cfg.n_heads * dh, dtype=dtype),
        "w_k": init_linear(gen, cfg.d_model, cfg.n_kv_heads * dh, dtype=dtype),
        "w_v": init_linear(gen, cfg.d_model, cfg.n_kv_heads * dh, dtype=dtype),
        "w_o": init_linear(gen, cfg.n_heads * dh, cfg.d_model, dtype=dtype),
    }


def cross_attention_kv(p: Params, cfg: ArchConfig, enc_out: torch.Tensor):
    dh = cfg.resolved_head_dim
    k = split_last(linear(p["w_k"], enc_out), cfg.n_kv_heads, dh)
    v = split_last(linear(p["w_v"], enc_out), cfg.n_kv_heads, dh)
    return k, v


def cross_attention(p: Params, cfg: ArchConfig, x: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    s = x.shape[1]
    q = split_last(linear(p["w_q"], x), cfg.n_heads, cfg.resolved_head_dim)
    q_pos = torch.arange(s, dtype=torch.int32, device=x.device)
    kv_pos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
    out = sdpa(q, k, v, q_pos, kv_pos, causal=False, impl="full")
    return linear(p["w_o"], merge_last(out))
