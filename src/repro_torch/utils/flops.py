"""Analytic model-FLOPs accounting (a port of ``repro.utils.flops``).

``MODEL_FLOPS = 6 * N * D`` for training, ``2 * N_active * D`` for inference,
with N the (active) parameter count and D the processed tokens.  Attention
score FLOPs are left out by the 6ND convention, so the ratio against the
FLOPs a step really does dips below 1 for long sequences.

``param_counts`` takes a param tree or the same tree of ``device="meta"``
tensors (``meta_params``: shapes without memory, the counterpart of
``jax.eval_shape`` of the init), so full-size counts cost nothing.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig, ShapeConfig
from .tree import leaves_with_path

__all__ = ["param_counts", "model_flops", "meta_params"]


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device: ``init_lm`` /
    ``init_encdec`` draw on ``gen.device``, so this builds a full-size tree
    of shapes and dtypes with no storage."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def meta_params(cfg: ArchConfig) -> Any:
    """``cfg``'s param tree as meta tensors (no memory, no draws)."""
    from ..models import get_model

    return get_model(cfg, device="meta").init(_MetaGenerator())


def param_counts(cfg: ArchConfig, params: Any) -> Dict[str, float]:
    """``{"total", "active"}`` parameter counts of a param (or meta) tree.

    ``active`` scales routed-expert weights (leaves under ``['experts']``) by
    ``top_k / n_routed``; embeddings stay in N, as MaxText / PaLM accounting
    keeps them.
    """
    total = 0
    active = 0.0
    for path, leaf in leaves_with_path(params):
        n = math.prod(leaf.shape)
        total += n
        if cfg.moe is not None and "['experts']" in path:
            active += n * (cfg.moe.top_k / cfg.moe.n_routed)
        else:
            active += n
    return {"total": float(total), "active": float(active)}


def model_flops(cfg: ArchConfig, shape: ShapeConfig, counts: Dict[str, float]) -> float:
    """Whole-step model FLOPs for ``shape`` (all devices together)."""
    n_active = counts["active"]
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    # decode: one token a sequence; the KV / state read is the memory story,
    # the FLOPs stay 2 N a token
    return 2.0 * n_active * shape.global_batch
