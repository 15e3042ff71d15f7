"""Uniform model API over every family (a port of ``repro.models.registry``).

``get_model(cfg)`` returns a :class:`Model` namespace with:

* ``init(gen)``                          -> params (``gen`` a ``torch.Generator``;
                                            the weights are drawn on its device)
* ``forward(params, batch)``             -> logits                 [prefill_*]
* ``init_cache(batch, max_len)``         -> caches
* ``decode_step(params, batch, caches)`` -> (logits, caches)      [decode_*]
* ``loss(params, batch)``                -> (scalar, metrics)      [train_*]
* ``input_specs(shape)``                 -> ``(step_name, batch, caches)``:
                                            the dry run's inputs for a shape
                                            cell, ``device="meta"`` tensors
                                            (JAX's ``ShapeDtypeStruct``)

``batch`` is a dict of tensors.  Decoder-only models (dense, MoE, VLM, SSM,
hybrid): ``{"tokens": [B, S]}`` (and ``"patch_embeds": [B, P, D]`` for a
VLM) for ``forward``, plus ``"labels"`` (and optional ``"weights"``) for
``loss``, ``{"tokens_t": [B, 1]}`` for ``decode_step``.  The
encoder-decoder (whisper): ``{"frames": [B, T_enc, D], "tokens"}`` for
``forward`` (``"labels"`` too for ``loss``); its ``init_cache`` gives the
decoder's self-attention caches, and ``decode_step`` takes and returns
``(self_caches, cross_kv)``, the cross K/V from
``encdec.precompute_cross_kv``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.base import ArchConfig, ShapeConfig
from . import encdec as encdec_mod
from . import transformer as lm_mod

__all__ = ["Model", "get_model"]

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[[torch.Generator], Params]
    loss: Callable[[Params, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Dict]]
    forward: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor]
    init_cache: Callable[[int, int], Any]
    decode_step: Callable[[Params, Dict[str, torch.Tensor], Any], Tuple[torch.Tensor, Any]]
    input_specs: Callable[[ShapeConfig], Tuple[str, Dict[str, Any], Any]]


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_spec(b: int, s: int) -> torch.Tensor:
    return _spec((b, s), torch.int32)


def get_model(cfg: ArchConfig, *, attn_impl: str = "auto", device=None) -> Model:
    """``cfg`` as a :class:`Model`; ``init_cache`` makes its caches on
    ``device`` (``None``: torch's default device)."""
    dtype = lm_mod.model_dtype(cfg)
    if cfg.is_encdec:
        return _encdec_model(cfg, dtype, device)
    return _lm_model(cfg, dtype, attn_impl, device)


def _lm_model(cfg: ArchConfig, dtype, attn_impl: str, device) -> Model:
    def init(gen: torch.Generator) -> Params:
        return lm_mod.init_lm(gen, cfg)

    def loss(params, batch):
        return lm_mod.loss_fn(params, cfg, batch, attn_impl=attn_impl)

    def forward(params, batch):
        return lm_mod.forward(params, cfg, batch["tokens"], patch_embeds=batch.get("patch_embeds"),
                              attn_impl=attn_impl)[0]

    def init_cache(batch: int, max_len: int):
        return lm_mod.init_cache(cfg, batch, max_len, dtype, device=device)

    def decode_step(params, batch, caches):
        return lm_mod.decode_step(params, cfg, batch["tokens_t"], caches)

    def input_specs(shape: ShapeConfig):
        b, s = shape.global_batch, shape.seq_len
        if shape.kind in ("train", "prefill"):
            text = s - cfg.vision_tokens if cfg.vision_tokens else s
            batch = {"tokens": _token_spec(b, text)}
            if shape.kind == "train":
                batch["labels"] = _token_spec(b, text)
            if cfg.vision_tokens:
                batch["patch_embeds"] = _spec((b, cfg.vision_tokens, cfg.d_model), dtype)
            return ("train_step" if shape.kind == "train" else "prefill"), batch, None
        # decode: one new token against a cache of size seq_len
        caches = lm_mod.init_cache(cfg, b, s, dtype, device="meta")
        return "serve_step", {"tokens_t": _token_spec(b, 1)}, caches

    return Model(cfg, init, loss, forward, init_cache, decode_step, input_specs)


def _encdec_model(cfg: ArchConfig, dtype, device) -> Model:
    def init(gen: torch.Generator) -> Params:
        return encdec_mod.init_encdec(gen, cfg)

    def loss(params, batch):
        return encdec_mod.loss_fn(params, cfg, batch)

    def forward(params, batch):
        enc = encdec_mod.encode(params, cfg, batch["frames"])
        return encdec_mod.decode_train(params, cfg, batch["tokens"], enc)

    def init_cache(batch: int, max_len: int):
        return encdec_mod.init_cache(cfg, batch, max_len, dtype=dtype, device=device)

    def decode_step(params, batch, caches):
        # the cross K/V ride along in ``caches`` as (self_caches, cross_kv)
        self_caches, cross_kv = caches
        logits, self_caches = encdec_mod.decode_step(params, cfg, batch["tokens_t"],
                                                     self_caches, cross_kv)
        return logits, (self_caches, cross_kv)

    def input_specs(shape: ShapeConfig):
        b, s = shape.global_batch, shape.seq_len
        frames = _spec((b, cfg.encoder_seq, cfg.d_model), dtype)
        if shape.kind == "train":
            return "train_step", {"frames": frames, "tokens": _token_spec(b, s),
                                  "labels": _token_spec(b, s)}, None
        if shape.kind == "prefill":
            return "prefill", {"frames": frames, "tokens": _token_spec(b, s)}, None
        self_caches = encdec_mod.init_cache(cfg, b, s, dtype=dtype, device="meta")
        kv = _spec((b, cfg.encoder_seq, cfg.n_kv_heads, cfg.resolved_head_dim), dtype)
        cross_kv = [(kv, kv) for _ in range(cfg.n_layers)]
        return "serve_step", {"tokens_t": _token_spec(b, 1)}, (self_caches, cross_kv)

    return Model(cfg, init, loss, forward, init_cache, decode_step, input_specs)
