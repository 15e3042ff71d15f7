"""Gradient compression for the data-parallel all-reduce (a port of
``repro.training.compression``).

``int8 + error feedback``: each data-parallel rank quantizes its local
gradient to int8 with a per-tensor f32 scale, the int8 payload is exchanged
(an all-gather of int8 on the wire), dequantized and averaged locally; the
quantization residual is *carried* to the next step (error feedback, Seide
et al. 2014 / Karimireddy et al. 2019) so the compression bias vanishes over
time.

Wire accounting against an f32 ring all-reduce (2 x N x 4 bytes a rank):
the all-gather moves (d-1)/d x N int8 bytes a rank, ~8x less traffic for
d >= 8.  ``topk + error feedback`` (sparsification) is the second policy;
``none`` is the plain mean.

The JAX package runs these inside ``shard_map``; here they are per-rank code
over ``torch.distributed`` collectives on the mesh axis's process group
(NCCL on the card, gloo on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch
import torch.distributed as dist

from ..utils.tree import leaves, tree_map

__all__ = ["CompressionConfig", "init_error_feedback", "quantize_int8", "dequantize_int8",
           "compressed_mean_grads", "make_compressed_allreduce", "wire_bytes"]

Tree = Any


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    policy: str = "int8"  # int8 | topk | none
    topk_frac: float = 0.01
    error_feedback: bool = True


def init_error_feedback(grads_template: Tree) -> Tree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads_template)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale f32 0-d)``: ``q = clip(round(x / scale), -127, 127)``
    with ``scale = max(max|x|, 1e-12) / 127`` (round half to even, as jnp)."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _topk_sparsify(x: torch.Tensor, frac: float) -> torch.Tensor:
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(x.abs() >= thresh, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _pmean(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out / dist.get_world_size(group)


def compressed_mean_grads(
    local_grad: torch.Tensor,
    err: torch.Tensor,
    *,
    group,
    cfg: CompressionConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's gradient compressed (with its carried error), exchanged
    over ``group`` and averaged; returns ``(mean f32, new error)``.  Every
    rank of ``group`` calls it, leaf for leaf in the same order."""
    g = local_grad.float()
    if cfg.policy == "none":
        return _pmean(g, group), err
    if cfg.error_feedback:
        g = g + err
    if cfg.policy == "topk":
        sent = _topk_sparsify(g, cfg.topk_frac)
        return _pmean(sent, group), g - sent
    if cfg.policy != "int8":
        raise ValueError(f"unknown compression policy {cfg.policy!r}")
    q, scale = quantize_int8(g)
    new_err = g - dequantize_int8(q, scale)
    d = dist.get_world_size(group)
    # the int8 payload on the wire; the f32 scales beside it (d floats)
    qs = torch.empty((d * q.numel(),), dtype=torch.int8, device=q.device)
    dist.all_gather_into_tensor(qs, q.reshape(-1), group=group)
    qs = qs.view(d, *q.shape)
    ss = torch.empty((d,), dtype=torch.float32, device=q.device)
    dist.all_gather_into_tensor(ss, scale.reshape(1), group=group)
    mean = torch.tensordot(ss, qs.float(), dims=([0], [0])) / d
    return mean, new_err


def make_compressed_allreduce(
    mesh,
    grads_template: Tree,
    *,
    axis_name: str = "data",
    cfg: CompressionConfig = CompressionConfig(),
) -> Callable[[Tree, Tree], Tuple[Tree, Tree]]:
    """``apply(local_grads, err) -> (mean_grads, err')`` on each rank:
    ``local_grads`` is this rank's gradient tree (shaped as
    ``grads_template``, computed on its own batch shard without the
    implicit mean), the means are equal on every rank of the ``axis_name``
    group, the errors stay per rank."""
    group = mesh.get_group(axis_name)
    shapes = [tuple(t.shape) for t in leaves(grads_template)]

    def apply(local_grads: Tree, err: Tree) -> Tuple[Tree, Tree]:
        got = [tuple(t.shape) for t in leaves(local_grads)]
        if got != shapes:
            raise ValueError(f"gradient shapes {got} differ from the template's {shapes}")
        pairs = [compressed_mean_grads(g, e, group=group, cfg=cfg)
                 for g, e in zip(leaves(local_grads), leaves(err))]
        means, errs = zip(*pairs) if shapes else ((), ())
        mi, ei = iter(means), iter(errs)
        return tree_map(lambda _: next(mi), local_grads), tree_map(lambda _: next(ei), local_grads)

    return apply


def wire_bytes(grads: Tree, world: int, cfg: CompressionConfig) -> Tuple[float, float]:
    """``(compressed, f32 ring all-reduce)`` bytes a rank sends for one
    exchange of ``grads``: the int8 all-gather ``(d-1)/d x (N + 4)`` a leaf,
    top-k / none an all-reduce of f32 (``2 (d-1)/d x 4 N``)."""
    n = [t.numel() for t in leaves(grads)]
    f = (world - 1) / world
    ring = sum(2 * f * 4 * k for k in n)
    if cfg.policy == "int8":
        return sum(f * (k + 4) for k in n), ring
    return ring, ring
