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

__all__ = ["block_kinds", "init_layer", "init_lm", "forward", "prefill", "init_cache",
           "decode_step"]

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
