"""Uniform model API (a port of ``repro.models.registry`` for the dense
decoder family).

``get_model(cfg)`` returns a :class:`Model` namespace with:

* ``init(gen)``                          -> params (``gen`` a ``torch.Generator``;
                                            the weights are drawn on its device)
* ``forward(params, batch)``             -> logits                 [prefill_*]
* ``init_cache(batch, max_len)``         -> caches
* ``decode_step(params, batch, caches)`` -> (logits, caches)      [decode_*]
* ``loss(params, batch)``                -> (scalar, metrics)      [train_*]
* ``input_specs``                        -> raises: the dry-run specs wait for
                                            ROADMAP A9

``batch`` is a dict of tensors: ``{"tokens": [B, S]}`` for ``forward``,
``{"tokens", "labels"}`` (and optional ``"weights"``) for ``loss``,
``{"tokens_t": [B, 1]}`` for ``decode_step``.  The encoder-decoder,
MoE, SSM, hybrid and VLM families raise (``transformer._check_ported``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.base import ArchConfig, ShapeConfig
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


def get_model(cfg: ArchConfig, *, device=None) -> Model:
    """The dense decoder ``cfg`` as a :class:`Model`; ``init_cache`` makes
    its caches on ``device`` (``None``: torch's default device)."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is not ported yet (ROADMAP A7)")
    lm_mod._check_ported(cfg)
    dtype = lm_mod.model_dtype(cfg)

    def init(gen: torch.Generator) -> Params:
        return lm_mod.init_lm(gen, cfg)

    def loss(params, batch):
        return lm_mod.loss_fn(params, cfg, batch)

    def forward(params, batch):
        return lm_mod.forward(params, cfg, batch["tokens"])[0]

    def init_cache(batch: int, max_len: int):
        return lm_mod.init_cache(cfg, batch, max_len, dtype, device=device)

    def decode_step(params, batch, caches):
        return lm_mod.decode_step(params, cfg, batch["tokens_t"], caches)

    def input_specs(shape: ShapeConfig):
        raise NotImplementedError(
            "ShapeDtypeStruct input specs belong to the TPU dry-run (ROADMAP A9)")

    return Model(cfg, init, loss, forward, init_cache, decode_step, input_specs)
