"""Whisper-style encoder-decoder backbone (arXiv:2212.04356; a port of
``repro.models.encdec``).

The conv frontend is a stub, as in the JAX package: the caller feeds
precomputed frame embeddings ``[B, T_enc, D]`` (what Whisper's two strided
convs produce).  The transformer backbone is real:

* encoder: bidirectional self-attention + GeLU MLP, pre-LN, learned
  positions ``enc_pos``;
* decoder: causal self-attention + cross-attention + GeLU MLP, pre-LN.

Decode keeps each decoder layer's self-attention KV cache beside the cross
K/V, which depend only on the encoder output and are computed once
(``precompute_cross_kv``).  ``loss_fn`` is the mean next-token NLL through
an f32 ``log_softmax``, as in the JAX package (no label weights, no aux).
Layer norms take ``cfg.norm_eps``.  ``encode``, ``decode_train`` and
``loss_fn`` take the JAX package's ``remat`` (each layer checkpointed) and
``layout_scan`` (the unrolled loop's computation in eager PyTorch; see
``transformer._layer_order``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..configs.base import ArchConfig
from . import attention as attn_mod
from .ffn import init_mlp, mlp
from .layers import _normal, embed, init_embedding, init_layernorm, init_linear, layernorm, linear
from .sharding import gather_last, mesh_context, replicate_axis
from .transformer import checkpointed, model_dtype

__all__ = ["init_encdec", "encode", "decode_train", "loss_fn", "init_cache",
           "precompute_cross_kv", "decode_step"]

Params = Dict[str, Any]


def init_encoder_layer(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    dev = gen.device
    return {
        "norm1": init_layernorm(cfg.d_model, dtype, dev),
        "attn": attn_mod.init_gqa(gen, cfg, dtype),
        "norm2": init_layernorm(cfg.d_model, dtype, dev),
        "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def init_decoder_layer(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    dev = gen.device
    return {
        "norm1": init_layernorm(cfg.d_model, dtype, dev),
        "attn": attn_mod.init_gqa(gen, cfg, dtype),
        "norm_x": init_layernorm(cfg.d_model, dtype, dev),
        "cross": attn_mod.init_cross_attention(gen, cfg, dtype),
        "norm2": init_layernorm(cfg.d_model, dtype, dev),
        "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def init_encdec(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Every weight drawn from ``gen`` on its device, in order."""
    dtype = model_dtype(cfg)
    dev = gen.device
    return {
        "embed": init_embedding(gen, cfg.vocab_padded, cfg.d_model, dtype),
        "enc_pos": _normal(gen, (cfg.encoder_seq, cfg.d_model), 0.02, dtype),
        "encoder": [init_encoder_layer(gen, cfg, dtype) for _ in range(cfg.encoder_layers)],
        "enc_norm": init_layernorm(cfg.d_model, dtype, dev),
        "decoder": [init_decoder_layer(gen, cfg, dtype) for _ in range(cfg.n_layers)],
        "dec_norm": init_layernorm(cfg.d_model, dtype, dev),
        "lm_head": init_linear(gen, cfg.d_model, cfg.vocab_padded, dtype=dtype),
    }


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


def _run_stack(layers: List[Params], apply_one, x: torch.Tensor, *, remat: bool,
               layout_scan: bool) -> torch.Tensor:
    """``apply_one(p, x)`` over homogeneous layers in order, each
    checkpointed under ``remat``.  ``layout_scan`` is JAX's ``lax.scan``
    over stacked params; in eager PyTorch that is this same loop, so it
    changes nothing here."""
    del layout_scan
    for p in layers:
        x = checkpointed(apply_one)(p, x) if remat else apply_one(p, x)
    return x


def encode(params: Params, cfg: ArchConfig, frames: torch.Tensor, *, attn_impl="auto",
           remat: bool = False, layout_scan: bool = False) -> torch.Tensor:
    """``frames [B, T_enc, D]`` (the stub frontend's output) -> the encoder
    output ``[B, T_enc, D]``."""
    with mesh_context(frames, params):
        x = frames + params["enc_pos"][None, : frames.shape[1]]
        positions = _positions(x)

        def one(p, x):
            h = layernorm(p["norm1"], x, cfg.norm_eps)
            x = x + attn_mod.gqa_attention(p["attn"], cfg, h, positions, causal=False,
                                           impl=attn_impl)
            h = layernorm(p["norm2"], x, cfg.norm_eps)
            return x + mlp(p["ffn"], h, activation="gelu")

        x = _run_stack(params["encoder"], one, x, remat=remat, layout_scan=layout_scan)
        return layernorm(params["enc_norm"], x, cfg.norm_eps)


def decode_train(params: Params, cfg: ArchConfig, tokens: torch.Tensor, enc_out: torch.Tensor,
                 *, attn_impl="auto", remat: bool = False, layout_scan: bool = False
                 ) -> torch.Tensor:
    """Teacher-forced decoder pass: logits ``[B, S, V_pad]``."""
    with mesh_context(tokens, enc_out, params):
        x = embed(params["embed"], tokens)
        positions = _positions(x)

        def one(p, x):
            h = layernorm(p["norm1"], x, cfg.norm_eps)
            x = x + attn_mod.gqa_attention(p["attn"], cfg, h, positions, impl=attn_impl)
            h = layernorm(p["norm_x"], x, cfg.norm_eps)
            ck, cv = attn_mod.cross_attention_kv(p["cross"], cfg, enc_out)
            x = x + attn_mod.cross_attention(p["cross"], cfg, h, ck, cv)
            h = layernorm(p["norm2"], x, cfg.norm_eps)
            return x + mlp(p["ffn"], h, activation="gelu")

        x = _run_stack(params["decoder"], one, x, remat=remat, layout_scan=layout_scan)
        x = layernorm(params["dec_norm"], x, cfg.norm_eps)
        return _mask_pad_logits(cfg, linear(params["lm_head"], x))


def _mask_pad_logits(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) < cfg.vocab
        logits = torch.where(pad, logits, torch.full((), -1e30, dtype=logits.dtype,
                                                     device=logits.device))
    return logits


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
            remat: bool = False, layout_scan: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    enc_out = encode(params, cfg, batch["frames"], remat=remat, layout_scan=layout_scan)
    logits = decode_train(params, cfg, batch["tokens"], enc_out, remat=remat,
                          layout_scan=layout_scan)
    with mesh_context(logits):
        logp = torch.log_softmax(replicate_axis(logits.float(), -1), dim=-1)
        nll = -gather_last(logp, batch["labels"].long()[..., None])[..., 0]
        ce = nll.mean()
        return ce, {"ce": ce}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> List[Params]:
    """One self-attention KV cache a decoder layer (the cross K/V come from
    :func:`precompute_cross_kv`)."""
    return [attn_mod.init_kv_cache(cfg, batch, max_len, dtype=dtype, device=device)
            for _ in range(cfg.n_layers)]


def precompute_cross_kv(params: Params, cfg: ArchConfig, enc_out: torch.Tensor
                        ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    return [attn_mod.cross_attention_kv(p["cross"], cfg, enc_out) for p in params["decoder"]]


def decode_step(params: Params, cfg: ArchConfig, tokens_t: torch.Tensor, caches: List[Params],
                cross_kv: List[Tuple[torch.Tensor, torch.Tensor]]
                ) -> Tuple[torch.Tensor, List[Params]]:
    """One token through the decoder: ``(logits [B, 1, V_pad], caches)``."""
    x = embed(params["embed"], tokens_t)
    new_caches = []
    for p, cache, (ck, cv) in zip(params["decoder"], caches, cross_kv):
        h = layernorm(p["norm1"], x, cfg.norm_eps)
        mixed, cache = attn_mod.gqa_decode_step(p["attn"], cfg, h, cache)
        x = x + mixed
        h = layernorm(p["norm_x"], x, cfg.norm_eps)
        x = x + attn_mod.cross_attention(p["cross"], cfg, h, ck, cv)
        h = layernorm(p["norm2"], x, cfg.norm_eps)
        x = x + mlp(p["ffn"], h, activation="gelu")
        new_caches.append(cache)
    x = layernorm(params["dec_norm"], x, cfg.norm_eps)
    return _mask_pad_logits(cfg, linear(params["lm_head"], x)), new_caches
