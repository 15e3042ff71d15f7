"""GPipe-style pipeline parallelism over a mesh axis (a port of
``repro.training.pipeline_parallel``).

The model's layer stack is cut into P contiguous stages; M microbatches
stream through an (M + P - 1)-tick schedule: at tick t stage s holds
microbatch t - s when 0 <= t - s < M.  After each tick every stage hands its
activation to the next one on a ring (the last stage's slot to the first is
unused), as the JAX package's ``ppermute`` does; the last stage records the
finished microbatches, and their outputs are all-reduced to every stage (the
JAX package's one-hot ``psum``).

The JAX package differentiates the schedule with ``jax.grad``.  Here the
stage hand-off is an autograd ``Function`` (:class:`_Handoff`) that sends
the activation forward and, in the backward, receives its cotangent back
from the next stage while sending the one it received to the previous
stage.  Every rank must run every hand-off's backward, in the same order,
for those exchanges to pair up: as in JAX, stage 0 selects its microbatch
over the received activation with ``torch.where`` (a zero cotangent, but a
dependency) and the last hand-off's output is selected away from the
outputs the same way, so each tick's hand-off feeds the next and the
backward runs them in reverse tick order on every rank.

Shapes on each rank:
  params_stacked: [L, ...] leaves (all layers: this stage uses its ``Lp``
                  rows, and only those rows get a gradient -- sum over the
                  axis for the whole) or DTensors placed ``Shard(0)`` over
                  the axis (this stage's ``Lp``)
  x_micro:        [M, mb, ...] (all microbatches resident; simple GPipe;
                  stage 0's gradient is the whole)
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch
import torch.distributed as dist

from ..models.sharding import is_dtensor
from ..utils.tree import leaves, tree_map

__all__ = ["pipeline_forward", "make_pipelined_loss"]

Tree = Any


class _Handoff(torch.autograd.Function):
    """Send ``x`` to the next stage, return what the previous one sent;
    the backward sends the received cotangent back and receives ``x``'s."""

    @staticmethod
    def forward(ctx, x, group, nxt, prv):
        ctx.peers = group, nxt, prv
        out = torch.empty_like(x)
        _exchange(x.contiguous(), out, group, send_to=nxt, recv_from=prv)
        return out

    @staticmethod
    def backward(ctx, g):
        group, nxt, prv = ctx.peers
        gx = torch.empty_like(g)
        _exchange(g.contiguous(), gx, group, send_to=prv, recv_from=nxt)
        return gx, None, None, None


def _exchange(send, recv, group, *, send_to: int, recv_from: int) -> None:
    for r in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, send_to, group),
                                     dist.P2POp(dist.irecv, recv, recv_from, group)]):
        r.wait()


class _StageOutputs(torch.autograd.Function):
    """The all-reduce (sum) of every stage's finished outputs; the backward
    hands each stage the cotangent unchanged (the loss on every rank is the
    same function of the same replicated outputs), so no stage's share is
    counted twice."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _select(keep: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """``keep``, with ``other`` (broadcast to it) as a dependency whose
    cotangent is zero: ``torch.where`` on a false condition."""
    return torch.where(torch.zeros((), dtype=torch.bool, device=keep.device), other, keep)


def _stage_params(params_stacked: Tree, stage: int, n_stages: int) -> Tree:
    """This stage's ``[Lp, ...]`` slice of every leaf."""
    def local(p):
        if is_dtensor(p):
            return p.to_local()
        lp = p.shape[0] // n_stages
        return p[stage * lp:(stage + 1) * lp]
    return tree_map(local, params_stacked)


def _stage_scan(layer_fn, stage_params: Tree, x: torch.Tensor) -> torch.Tensor:
    """This stage's ``Lp`` layers applied in order to ``x``."""
    for i in range(leaves(stage_params)[0].shape[0]):
        x = layer_fn(tree_map(lambda a: a[i], stage_params), x)
    return x


def pipeline_forward(
    layer_fn: Callable[[Tree, torch.Tensor], torch.Tensor],
    params_stacked: Tree,
    x_micro: torch.Tensor,
    *,
    mesh,
    axis_name: str = "pipe",
) -> torch.Tensor:
    """Run the pipeline; returns outputs ``[M, mb, ...]``, equal on every
    stage.  Every rank of the axis calls it with the same ``x_micro``."""
    group = mesh.get_group(axis_name)
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)
    m = x_micro.shape[0]
    last = stage == n_stages - 1
    sp = _stage_params(params_stacked, stage, n_stages)

    # a carry that requires grad when anything does: every hand-off then gets
    # a backward node on every rank, inactive ticks included
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in leaves(params_stacked) + [x_micro])
    carry = torch.zeros_like(x_micro[0]).requires_grad_(needs_grad)
    finished: List[torch.Tensor] = []
    for t in range(m + n_stages - 1):
        mb = t - stage
        active = 0 <= mb < m
        # stage 0 reads its own microbatch; later stages read the carry
        inp = _select(x_micro[min(t, m - 1)], carry) if stage == 0 else carry
        out = _stage_scan(layer_fn, sp, inp) if active else carry
        if active and last:
            finished.append(out)
        carry = _Handoff.apply(out, group, nxt, prv) if n_stages > 1 else out
    outputs = torch.stack(finished) if last else torch.zeros_like(x_micro)
    if n_stages == 1:
        return outputs
    return _StageOutputs.apply(_select(outputs, carry), group)


def make_pipelined_loss(
    layer_fn: Callable[[Tree, torch.Tensor], torch.Tensor],
    head_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    *,
    mesh,
    axis_name: str = "pipe",
):
    """``loss(params_stacked, x_micro, labels_micro) -> scalar``
    (differentiable)."""

    def loss(params_stacked, x_micro, labels_micro):
        out = pipeline_forward(layer_fn, params_stacked, x_micro, mesh=mesh,
                               axis_name=axis_name)
        return head_fn(out, labels_micro)

    return loss
