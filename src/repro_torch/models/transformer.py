"""Decoder-only LM of the dense family (a port of ``repro.models.transformer``
for attention blocks): ``block_kinds``, ``init_layer``, ``init_lm``,
``forward``, ``_unembed`` and the serving trio ``prefill`` / ``init_cache``
/ ``decode_step`` (one KV cache a layer, ``pos`` per row).

Every layer is a pre-norm GQA attention block and a pre-norm gated MLP.
``forward`` runs whole sequences with plain torch ops (no remat, no scan,
no patch embeds); it is the reference the plan-compiled decoder is held to.
Under ``cfg.prune.enabled`` the layers carry the paper's recipe as packed
params (block-pruned q/o for a ``bsr`` execution mode, column-pruned FFN),
which ``forward`` runs in plain torch (``bsr_xla`` / ``colpack_xla``), as
the JAX package does.  The MoE, SSM and hybrid families come with a later
slice.

``loss_fn`` is the training loss (next-token cross entropy through an f32
``logsumexp``), differentiated by plain autograd as the JAX package
differentiates its forward with plain XLA: no kernel of the port runs in
training.

``init_lm`` draws every weight from one ``torch.Generator`` on that
generator's device, in order (embedding, layers, lm_head): pass a CUDA
generator to draw a full-width model on the card.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..configs.base import ArchConfig
from . import attention as attn_mod
from . import ffn as ffn_mod
from .layers import embed, init_embedding, init_linear, init_rmsnorm, linear, rmsnorm

__all__ = ["block_kinds", "init_layer", "init_lm", "forward", "loss_fn", "prefill",
           "init_cache", "decode_step"]

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def block_kinds(cfg: ArchConfig) -> List[str]:
    if cfg.ssm is not None:
        return ["mamba"] * cfg.n_layers
    if cfg.recurrent is not None:
        pat = cfg.recurrent.pattern
        return [pat[i % len(pat)] for i in range(cfg.n_layers)]
    return ["attn"] * cfg.n_layers


def _check_ported(cfg: ArchConfig) -> None:
    if set(block_kinds(cfg)) != {"attn"} or cfg.moe is not None or cfg.kv_lora_rank \
            or cfg.vision_tokens or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: only dense GQA decoders are ported (family {cfg.family!r})"
        )


def init_layer(gen: torch.Generator, cfg: ArchConfig, i: int, dtype=torch.bfloat16) -> Params:
    _check_ported(cfg)
    # paper recipe: column-prune the FFN
    prune = ("colpack_xla", cfg.prune.sparsity) if cfg.prune.enabled else None
    return {
        "norm1": init_rmsnorm(cfg.d_model, dtype, gen.device),
        "attn": attn_mod.init_gqa(gen, cfg, dtype),
        "norm2": init_rmsnorm(cfg.d_model, dtype, gen.device),
        "ffn": ffn_mod.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, prune=prune),
    }


def init_lm(gen: torch.Generator, cfg: ArchConfig) -> Params:
    _check_ported(cfg)
    dtype = model_dtype(cfg)
    p: Params = {
        "embed": init_embedding(gen, cfg.vocab_padded, cfg.d_model, dtype),
        "layers": [init_layer(gen, cfg, i, dtype) for i in range(cfg.n_layers)],
        "final_norm": init_rmsnorm(cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_padded, dtype=dtype)
    return p


def _apply_block(p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                 mode: str) -> torch.Tensor:
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    x = x + attn_mod.gqa_attention(p["attn"], cfg, h, positions, mode=mode)
    h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + ffn_mod.mlp(p["ffn"], h2, activation=cfg.ffn_activation, mode=mode)


def forward(
    params: Params, cfg: ArchConfig, tokens: torch.Tensor, *, mode: str = "dense"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(logits [B, S, V_pad], aux_loss)``; pad classes are
    ``-1e30`` (aux is 0: no MoE layer)."""
    _check_ported(cfg)
    x = embed(params["embed"], tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    for p in params["layers"]:
        x = _apply_block(p, cfg, x, positions, mode)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


def _unembed(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].T
    else:
        logits = linear(params["lm_head"], x)
    if cfg.vocab_padded != cfg.vocab:  # mask pad classes (never predicted)
        pad = torch.arange(cfg.vocab_padded, device=x.device) < cfg.vocab
        logits = torch.where(pad, logits, torch.full((), -1e30, dtype=logits.dtype,
                                                     device=x.device))
    return logits


def loss_fn(
    params: Params,
    cfg: ArchConfig,
    batch: Dict[str, torch.Tensor],
    *,
    attn_impl: str = "auto",
    mode: str = "dense",
    remat: bool = False,
    layout_scan: bool = False,
    remat_policy: str = "full",
    residual_spec=None,
    attn_chunk: int = 1024,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy over ``batch["tokens"]`` / ``batch["labels"]``
    (``[B, S]`` ints), weighted by ``batch["weights"]`` when given; returns
    ``(total, {"ce", "aux"})`` with aux 0 (no MoE family is ported).

    ``remat``, ``layout_scan``, ``residual_spec`` and ``attn_chunk`` are the
    TPU package's memory and sharding knobs: only their defaults are taken
    (the rest wait for ROADMAP A9).  ``attn_impl`` "auto" is full attention
    at every length the port runs, as in JAX below 8192 keys."""
    if (remat, layout_scan, remat_policy, residual_spec, attn_chunk) != (
            False, False, "full", None, 1024) or attn_impl not in ("auto", "full"):
        raise NotImplementedError(
            "remat / layout_scan / residual_spec / attn_chunk / chunked attention are TPU "
            "memory and sharding knobs; only their defaults are ported (ROADMAP A9)")
    logits, aux = forward(params, cfg, batch["tokens"], mode=mode)
    labels = batch["labels"].long()
    # CE via logsumexp: one f32 reduction instead of a full log_softmax copy
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    picked = torch.gather(logits32, -1, labels[..., None])[..., 0]
    nll = lse - picked
    weights = batch.get("weights")
    if weights is None:
        weights = torch.ones_like(nll)
    ce = torch.sum(nll * weights) / torch.clamp(torch.sum(weights), min=1.0)
    return ce, {"ce": ce, "aux": aux}


# --------------------------------------------------------------------------- #
# serving: prefill (forward + populated caches), empty caches, one decode step #
# --------------------------------------------------------------------------- #


def prefill(
    params: Params, cfg: ArchConfig, tokens: torch.Tensor, max_len: int
) -> Tuple[torch.Tensor, List[Params]]:
    """Returns ``(logits [B, S, V_pad], caches)``: one KV cache of
    ``max_len`` slots a layer, every row positioned at ``S``."""
    _check_ported(cfg)
    x = embed(params["embed"], tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    caches: List[Params] = []
    for p in params["layers"]:
        h = rmsnorm(p["norm1"], x, cfg.norm_eps)
        mixed, cache = attn_mod.gqa_prefill(p["attn"], cfg, h, positions, max_len)
        x = x + mixed
        h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + ffn_mod.mlp(p["ffn"], h2, activation=cfg.ffn_activation)
        caches.append(cache)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(params, cfg, x), caches


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> List[Params]:
    """Empty per-layer KV caches (``attention.init_kv_cache``)."""
    _check_ported(cfg)
    return [attn_mod.init_kv_cache(cfg, batch, max_len, dtype=dtype, device=device)
            for _ in block_kinds(cfg)]


def decode_step(
    params: Params,
    cfg: ArchConfig,
    tokens_t: torch.Tensor,  # [B, 1] int
    caches: List[Params],
    *,
    mode: str = "dense",
) -> Tuple[torch.Tensor, List[Params]]:
    """One token for the whole stack.  Returns ``(logits [B, 1, V_pad],
    caches)``: new cache tensors, the inputs are not modified."""
    _check_ported(cfg)
    x = embed(params["embed"], tokens_t)
    new_caches: List[Params] = []
    for p, cache in zip(params["layers"], caches):
        h = rmsnorm(p["norm1"], x, cfg.norm_eps)
        mixed, cache = attn_mod.gqa_decode_step(p["attn"], cfg, h, cache, mode=mode)
        x = x + mixed
        h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + ffn_mod.mlp(p["ffn"], h2, activation=cfg.ffn_activation, mode=mode)
        new_caches.append(cache)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(params, cfg, x), new_caches
