"""AdamW + schedules + global-norm clipping as plain functions on tensor
trees (a port of ``repro.training.optimizer``).

The JAX package's semantics are kept, not ``torch.optim.AdamW``'s: weight
decay is added to the update ``delta`` (``p -= lr * (mhat / (sqrt(vhat) +
eps) + wd * p)``) and applies to matrices only (``p.ndim >= 2``); the
moments are stored in ``state_dtype`` while the update runs in f32 and the
result is cast back to each param's dtype; the learning rate of step ``t``
is ``cosine_schedule(t)`` with the pre-increment count.

Two differences from the JAX functions, both for a full-width run on one
card: the step count and the learning rate live on the host (an int, and a
float that is an exact f32 value), so no step needs a device sync; and
:func:`adamw_update` / :func:`clip_by_global_norm` update the params,
moments and grads in place, leaf by leaf, where a jitted JAX step would get
the same effect from donated buffers.

On a mesh (DTensor params, ``models.sharding``) the same functions run
unchanged.  ``zero1_pspecs`` gives ZeRO-1 moment specs (each moment split
over ``data`` along the first dim its param leaves replicated) and
``adamw_init(..., mesh=, moment_specs=)`` places the moments so; inside the
in-place update DTensor slices the gradient to the moment's placement, and
``p.copy_`` gathers the updated slices back to the param's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.sharding import P, is_dtensor, param_placements
from ..utils.tree import leaves, tree_map

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "linear_warmup",
    "global_norm",
    "clip_by_global_norm",
    "zero1_pspecs",
]

Tree = Any

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    #: keep Adam moments in this dtype (bf16 halves optimizer memory; the
    #: update math still runs in f32)
    state_dtype: str = "float32"


class AdamWState(NamedTuple):
    step: int
    m: Tree
    v: Tree


def adamw_init(params: Tree, config: AdamWConfig, *, mesh=None,
               moment_specs: Optional[Tree] = None) -> AdamWState:
    """Zero moments in ``config.state_dtype``: placed by ``moment_specs``
    on ``mesh`` when given (ZeRO-1), else as each param."""
    dt = _STATE_DTYPES[config.state_dtype]

    def zeros(p, spec=None):
        if spec is not None:
            from torch.distributed.tensor import zeros as dzeros

            return dzeros(p.shape, dtype=dt, device_mesh=mesh,
                          placements=param_placements(mesh, spec))
        if is_dtensor(p):
            return torch.zeros_like(p, dtype=dt)
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    if moment_specs is None:
        return AdamWState(step=0, m=tree_map(zeros, params), v=tree_map(zeros, params))
    return AdamWState(step=0, m=tree_map(zeros, params, moment_specs),
                      v=tree_map(zeros, params, moment_specs))


_F = np.float32


def linear_warmup(step: int, warmup: int) -> float:
    return float(min(_F(1.0), _F(step + 1) / _F(max(warmup, 1))))


def cosine_schedule(step: int, config: AdamWConfig) -> float:
    """The learning rate of (0-based) ``step``, computed in f32 as the JAX
    package computes it."""
    warm = _F(linear_warmup(step, config.warmup_steps))
    t = _F(step - config.warmup_steps) / _F(max(config.total_steps - config.warmup_steps, 1))
    t = min(max(t, _F(0.0)), _F(1.0))
    cos = _F(0.5) * (_F(1) + np.cos(_F(math.pi) * t, dtype=_F))
    frac = _F(config.min_lr_frac) + (_F(1) - _F(config.min_lr_frac)) * cos
    return float(_F(config.lr) * warm * frac)


def global_norm(tree: Tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm`` (f32 product, cast back); returns ``(grads, norm)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in leaves(grads):
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, norm


@torch.no_grad()
def adamw_update(
    grads: Tree,
    state: AdamWState,
    params: Tree,
    config: AdamWConfig,
) -> Tuple[Tree, AdamWState, Dict[str, Any]]:
    """Returns (new_params, new_state, metrics); params, moments and grads
    are updated in place (the returned trees hold the same tensors)."""
    if config.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, config.grad_clip)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = cosine_schedule(state.step, config)
    b1, b2 = config.b1, config.b2
    bc1 = float(_F(1) - _F(b1) ** _F(step))
    bc2 = float(_F(1) - _F(b2) ** _F(step))

    def upd(p, g, m, v):
        if g is None:  # a leaf without a gradient
            return p
        gf = g.float()
        # mf = b1 * m + (1 - b1) * g; vf = b2 * v + (1 - b2) * g * g -- in
        # f32, rounded as the JAX expressions round (no fused multiply-add)
        mf = m.float().mul_(b1).add_(gf * (1 - b1))
        vf = v.float().mul_(b2).add_((gf * (1 - b2)).mul_(gf))
        del gf
        delta = mf / bc1
        delta.div_((vf / bc2).sqrt_().add_(config.eps))
        if config.weight_decay and p.ndim >= 2:  # decay matrices only
            delta.add_(p.float() * config.weight_decay)
        if m.dtype != torch.float32:  # f32 moments were updated in place
            m.copy_(mf)
            v.copy_(vf)
        del mf, vf
        p.copy_(p.float() - delta.mul_(lr))
        return p

    new_params = tree_map(upd, params, grads, state.m, state.v)
    return new_params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}


def zero1_pspecs(
    param_pspecs: Tree,
    params: Optional[Tree] = None,
    *,
    data_axis: str = "data",
    data_size: int = 0,
) -> Tree:
    """ZeRO-1: shard optimizer moments along the first dim the param spec
    leaves replicated (classic moment sharding over data).

    When ``params`` / ``data_size`` are given, only dims divisible by the
    data axis are sharded (uneven leaves like positional tables stay
    replicated).  A spec that already uses ``data_axis`` (FSDP rules) is
    kept."""

    def shard(spec: P, leaf=None) -> P:
        shape = getattr(leaf, "shape", None)
        parts = list(spec) if len(spec) else ([None] * (len(shape) if shape else 0))
        used = {a for i in range(len(parts)) for a in P(*parts).axes(i)}
        if data_axis in used:
            return spec
        for i, part in enumerate(parts):
            if part is None:
                if shape is not None and data_size and shape[i] % data_size != 0:
                    continue
                parts[i] = data_axis
                return P(*parts)
        return spec  # fully sharded already (or nothing divisible)

    if params is None:
        return tree_map(shard, param_pspecs)
    return tree_map(shard, param_pspecs, params)
