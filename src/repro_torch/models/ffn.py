"""FFN blocks (a port of ``repro.models.ffn``): the gated MLP (SwiGLU /
GeGLU) and DeepSeek-style MoE (shared + routed experts, top-k, gather-based
dispatch).

``mlp(fused=True)`` runs the first half through the fused gate/up kernel
(:func:`repro_torch.kernels.ops.ffn_gateup`).  ``init_mlp(prune=(mode,
sparsity))`` draws the paper's column-pruned FFN (packed params), which
``mlp`` dispatches on (``layers.linear_auto``).

``moe`` dispatches each batch row on its own (the row is the JAX package's
dispatch group): tokens are sorted to their experts' slots up to a capacity
of ``max(int(S * top_k / E * capacity_factor), 4)`` slots an expert, the
expert stacks ``[E, D, F]`` run as batched products over ``[B, E, C, D]``,
and the outputs are gathered back to their token-slots.  The bookkeeping is
the JAX package's, bit for bit, including what it does past capacity: an
overflowing token-slot is clamped to slot ``C - 1`` and written there, so
the last writer owns the slot (``_dispatch_indices``).  The top-k keeps the
lower expert index on a tie, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig, MoEConfig
from ..kernels import ops as kops
from ..kernels.ref import _ACT
from .layers import _normal, init_linear, init_pruned_linear, linear, linear_auto
from .sharding import on_experts, on_rows, whole_if_uneven

__all__ = ["init_mlp", "mlp", "init_moe", "moe"]

Params = Dict[str, Any]


def init_mlp(
    gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.bfloat16,
    prune: Optional[Tuple[str, float]] = None,
) -> Params:
    def lin(d_in, d_out):
        if prune is None:
            return init_linear(gen, d_in, d_out, dtype=dtype)
        # the paper's FFN recipe: column pruning -> packed smaller GEMMs
        return init_pruned_linear(gen, d_in, d_out, exec_mode=prune[0], sparsity=prune[1],
                                  dtype=dtype)

    return {"w_gate": lin(d_model, d_ff), "w_up": lin(d_model, d_ff), "w_down": lin(d_ff, d_model)}


def mlp(
    p: Params,
    x: torch.Tensor,
    *,
    activation: str = "silu",
    mode: str = "dense",
    fused: bool = False,
) -> torch.Tensor:
    # ``fused`` defaults to False as in the JAX package's ``ffn.mlp``: the
    # forward-based path runs plain torch there and here (parity)
    if fused and mode in ("dense", "masked") and "w" in p["w_gate"]:
        wg, wu = p["w_gate"]["w"], p["w_up"]["w"]
        if mode == "masked":
            wg = wg * p["w_gate"]["mask"].to(wg.dtype)
            wu = wu * p["w_up"]["mask"].to(wu.dtype)
        h = kops.ffn_gateup(x, wg, wu, activation=activation)
    else:
        g = linear_auto(p["w_gate"], x, mode, activation=activation)
        u = linear_auto(p["w_up"], x, mode)
        h = g * u
    return linear_auto(p["w_down"], h, mode)


# --------------------------------------------------------------------------- #
# MoE                                                                          #
# --------------------------------------------------------------------------- #


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype=torch.bfloat16) -> Params:
    mc = cfg.moe
    d, f = cfg.d_model, mc.d_expert
    scale = 1.0 / math.sqrt(d)
    p: Params = {
        "router": init_linear(gen, d, mc.n_routed, dtype=torch.float32),
        "experts": {
            "w_gate": _normal(gen, (mc.n_routed, d, f), scale, dtype),
            "w_up": _normal(gen, (mc.n_routed, d, f), scale, dtype),
            "w_down": _normal(gen, (mc.n_routed, f, d), scale, dtype),
        },
    }
    if mc.n_shared:
        p["shared"] = init_mlp(gen, d, f * mc.n_shared, dtype)
    return p


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last axis, a tie going to the lower index
    (``jax.lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(expert_idx: torch.Tensor, n_experts: int, capacity: int):
    """``_dispatch_indices`` plus each token-slot's flat slot ``[G, Tk]``."""
    g_, tk = expert_idx.shape
    e_idx = expert_idx.long()
    onehot = torch.nn.functional.one_hot(e_idx, n_experts)  # [G, Tk, E]
    pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(dim=-1)  # slot within expert
    kept = pos < capacity
    flat_slot = e_idx * capacity + torch.clamp(pos, max=capacity - 1)
    arange_tk = torch.arange(tk, device=expert_idx.device).expand(g_, tk)
    last = torch.full((g_, n_experts * capacity), -1, dtype=torch.long, device=expert_idx.device)
    last = last.scatter_reduce(1, flat_slot, arange_tk, reduce="amax", include_self=True)
    slot_valid = torch.gather(kept, 1, last.clamp(min=0)) & (last >= 0)
    gather_idx = torch.where(slot_valid, last, torch.zeros_like(last))
    return gather_idx, slot_valid, kept, flat_slot


def _dispatch_indices(expert_idx: torch.Tensor, n_experts: int, capacity: int):
    """Dispatch bookkeeping per group (batch row).  ``expert_idx [G, Tk]``
    is the expert of each (group, token-slot).  Returns ``gather_idx [G, E,
    C]`` (int32: the token-slot filling each expert slot), ``slot_valid [G,
    E, C]`` and ``kept [G, Tk]`` (the token-slot got a slot under capacity).

    Every token-slot writes ``(kept ? t : 0, kept)`` to its flat slot
    ``e * C + min(pos, C - 1)``, in token order, and the last write wins, as
    the JAX package's scatter does on the CPU; the winner of each slot is
    computed as its largest writer (a max: deterministic on any device)."""
    g_ = expert_idx.shape[0]
    gather_idx, slot_valid, kept, _ = _dispatch(expert_idx, n_experts, capacity)
    return (gather_idx.to(torch.int32).reshape(g_, n_experts, capacity),
            slot_valid.reshape(g_, n_experts, capacity), kept)


def _gather_in(x: torch.Tensor, expert_idx: torch.Tensor, *, n_e: int, capacity: int, k: int):
    """Each expert slot's token row of ``x [B, S, D]`` (zero where the slot is
    empty), ``[B, E, C, D]``, with the dispatch bookkeeping."""
    gather_idx, slot_valid, kept, flat_slot = _dispatch(expert_idx, n_e, capacity)
    token_of_slot = torch.div(gather_idx, k, rounding_mode="floor")  # [B, E*C]
    xe = torch.gather(x, 1, token_of_slot[..., None].expand(-1, -1, x.shape[-1]))
    xe = xe * slot_valid[..., None].to(x.dtype)
    return xe.reshape(x.shape[0], n_e, capacity, -1), gather_idx, slot_valid, kept, flat_slot


def _experts(xe: torch.Tensor, we: Params, *, activation: str) -> torch.Tensor:
    """The expert stacks' gated MLP over their slots: ``[B, E, C, D]`` in and
    out."""
    gt = _einsum("becd,edf->becf", xe, we["w_gate"])
    ut = _einsum("becd,edf->becf", xe, we["w_up"])
    h = _ACT["silu" if activation == "silu" else "gelu"](gt.float()).to(gt.dtype) * ut
    return _einsum("becf,efd->becd", h, we["w_down"])


def _gather_out(ye: torch.Tensor, slot_valid: torch.Tensor, gather_idx: torch.Tensor,
                flat_slot: torch.Tensor) -> torch.Tensor:
    """Each token-slot's expert output ``[B, Tk, D]`` from the slots' outputs
    ``ye [B, E, C, D]``: the slot it was written to, if it still owns it
    (what the JAX package's scatter-add of the valid slots' outputs gives: a
    token-slot owns at most one slot)."""
    ye = ye.reshape(ye.shape[0], -1, ye.shape[-1])
    owner = (torch.gather(slot_valid, 1, flat_slot)
             & (torch.gather(gather_idx, 1, flat_slot)
                == torch.arange(flat_slot.shape[1], device=flat_slot.device)))
    y_slots = torch.gather(ye, 1, flat_slot[..., None].expand(-1, -1, ye.shape[-1]))
    return y_slots * owner[..., None].to(ye.dtype)


def _einsum(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with jnp's type promotion (f32 tokens, bf16 experts)."""
    if x.dtype != w.dtype:
        t = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(t), w.to(t)
    return torch.einsum(eq, x, w)


def moe(p: Params, cfg: ArchConfig, x: torch.Tensor, *, activation: str = "silu"
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(output, router_aux_loss)``; ``x [B, S, D]``.  The aux loss
    is Switch-style: ``E * sum(mean router prob * top-1 load)``, f32."""
    mc: MoEConfig = cfg.moe
    # the [B, S*k] views below take only even cuts: on a mesh whose batch
    # axes a batch does not divide (a one-row prefill, an odd batch),
    # DTensor's matmuls may have cut the rows or the sequence over them
    x = whole_if_uneven(x, 0, 1)
    b, s, d = x.shape
    k, n_e = mc.top_k, mc.n_routed
    probs = torch.softmax(linear(p["router"], x.float()), dim=-1)  # [B, S, E]
    top_p, top_i = _top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)  # renorm

    capacity = max(int(s * k / n_e * mc.capacity_factor), 4)
    expert_idx = top_i.reshape(b, s * k)  # [B, Tk]
    # dispatch and combine are row-wise: on a mesh each rank runs them on its
    # batch rows (``on_rows``), and the experts on its rows and experts
    # (``on_experts``)
    xe, gather_idx, slot_valid, kept, flat_slot = on_rows(
        functools.partial(_gather_in, n_e=n_e, capacity=capacity, k=k), x, expert_idx)
    ye = on_experts(functools.partial(_experts, activation=activation), xe, p["experts"])

    # combine: each token-slot reads back the expert slot it was written to
    y_slots = on_rows(_gather_out, ye, slot_valid, gather_idx, flat_slot)
    w_slots = (top_p.reshape(b, -1, 1) * kept.reshape(b, -1, 1)).to(ye.dtype)
    y = (y_slots * w_slots).reshape(b, s, k, d).sum(dim=2)

    if "shared" in p:
        y = y + mlp(p["shared"], x, activation=activation)

    me = probs.mean(dim=(0, 1))  # [E] mean router prob
    ce = torch.nn.functional.one_hot(top_i[..., 0], n_e).float().mean(dim=(0, 1))  # top-1 load
    aux = n_e * torch.sum(me * ce)
    return y, aux.float()

