"""Train-step factory: task loss + ADMM augment + gradient accumulation +
AdamW over a :class:`TrainState` (a port of ``repro.training.train_loop``).

The ADMM machinery (the paper's pruning) is a first-class member of the
train state: the penalty joins the loss every step, and the Z/U
(projection / dual) update runs when the post-increment optimizer step is a
multiple of ``admm.update_every`` -- the condition of the JAX package's
``lax.cond``, decided here on the host step count, so no device sync.

The step differentiates with plain autograd (the JAX package takes
``jax.value_and_grad`` of plain XLA ops; no kernel of either package runs
in training) and updates the state's tensors in place: pass a copy of a
state that must survive the step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core.pruning.admm import (
    AdmmConfig,
    AdmmState,
    admm_init,
    admm_penalty,
    admm_update,
    convergence_metrics,
)
from ..core.pruning.masks import apply_masks, mask_gradients
from ..models.sharding import mesh_context, on_whole
from ..utils.tree import leaves, map_with_path, tree_map
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update

__all__ = ["TrainState", "init_train_state", "make_train_step"]

Tree = Any
Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    params: Tree
    opt: AdamWState
    admm: Optional[AdmmState] = None
    #: mask tree for masked fine-tuning after hard prune (None = dense phase)
    masks: Optional[Tree] = None


def init_train_state(
    params: Tree,
    opt_cfg: AdamWConfig,
    *,
    admm_cfg: Optional[AdmmConfig] = None,
    prune_plan=None,
    masks: Optional[Tree] = None,
) -> TrainState:
    admm = None
    if admm_cfg is not None and prune_plan is not None:
        admm = admm_init(params, prune_plan, admm_cfg)
    return TrainState(params=params, opt=adamw_init(params, opt_cfg), admm=admm, masks=masks)


def _value_and_grad(loss_fn, state: TrainState, batch: Batch):
    """``(loss, metrics), grads`` of the task loss on the effective (masked)
    params plus the ADMM penalty on the raw params."""
    ws = leaves(state.params)
    for w in ws:
        w.requires_grad_(True)
    try:
        # on a mesh, the backward meets the constants the forward built
        with mesh_context(state.params, batch):
            p_eff = apply_masks(state.params, state.masks) if state.masks is not None \
                else state.params
            loss, metrics = loss_fn(p_eff, batch)
            if state.admm is not None:
                loss = loss + admm_penalty(state.params, state.admm)
            grads = torch.autograd.grad(loss, ws, allow_unused=True)
    finally:
        for w in ws:
            w.requires_grad_(False)
    # a leaf the loss does not reach gets a zero gradient, as in JAX
    it = iter(torch.zeros_like(w) if g is None else g for w, g in zip(ws, grads))
    grad_tree = map_with_path(lambda *_: next(it), state.params)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grad_tree


def make_train_step(
    loss_fn: Callable[[Tree, Batch], Tuple[torch.Tensor, Dict]],
    opt_cfg: AdamWConfig,
    *,
    admm_cfg: Optional[AdmmConfig] = None,
    accum: int = 1,
) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, Any]]]:
    """Build ``step(state, batch) -> (state, metrics)``.

    ``accum > 1`` splits the batch leading dim into micro-batches whose f32
    gradients are summed and divided by ``accum`` (the optimizer sees the
    mean gradient; the metrics are the last micro-batch's, the loss the
    mean).  On a mesh micro-batch ``i`` is the JAX package's rows of the
    global batch, ``[i * B / accum, (i + 1) * B / accum)``, placed as the
    batch (``sharding.on_whole``), and the accumulators are placed like
    the params.
    """

    def micro(v, i):
        return v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]

    def compute_grads(state: TrainState, batch: Batch):
        if accum == 1:
            return _value_and_grad(loss_fn, state, batch)
        acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), state.params)
        loss_sum = 0.0
        for i in range(accum):
            mb = {k: on_whole(lambda t: micro(t, i), v) for k, v in batch.items()}
            loss, metrics, grads = _value_and_grad(loss_fn, state, mb)
            tree_map(lambda a, g: a.add_(g.float()), acc, grads)
            loss_sum = loss_sum + loss
            del grads
        acc = tree_map(lambda g: g.div_(accum), acc)
        return loss_sum / accum, metrics, acc

    def step(state: TrainState, batch: Batch):
        loss, metrics, grads = compute_grads(state, batch)
        if state.masks is not None:
            grads = mask_gradients(grads, state.masks)
        new_params, opt, opt_metrics = adamw_update(grads, state.opt, state.params, opt_cfg)
        del grads

        admm = state.admm
        admm_metrics: Dict[str, Any] = {}
        if admm is not None and admm_cfg is not None:
            if opt.step % admm_cfg.update_every == 0:
                admm = admm_update(new_params, admm, admm_cfg)
            admm_metrics = convergence_metrics(new_params, admm)

        out = {"loss": loss, **metrics, **opt_metrics, **admm_metrics}
        return TrainState(params=new_params, opt=opt, admm=admm, masks=state.masks), out

    return step
