"""ADMM structured pruning (a port of ``repro.core.pruning.admm``: the
paper's uniform pruning framework, section 2).

Solves  ``min_W f(W)  s.t.  W_i in S_i``  by ADMM.  With ``g`` the indicator
of ``S`` and the constraint ``W = Z``::

    W-step:  W <- argmin_W f(W) + rho/2 * ||W - Z + U||^2     (SGD, T steps)
    Z-step:  Z <- Pi_S(W + U)                                  (projection)
    U-step:  U <- U + W - Z                                    (dual ascent)

The W-step is folded into normal training: :func:`admm_penalty` returns the
quadratic augment to add to the task loss; :func:`admm_update` performs the
Z/U steps (run every ``update_every`` optimizer steps); :func:`hard_prune`
projects the final weights and returns masks for masked fine-tuning.

Z and U are f32 trees that mirror the params with ``None`` on dense leaves;
on a mesh each is a DTensor placed like its weight (the JAX package's Z and
U inherit each weight's sharding), the Z-step projecting the whole leaf
(``projections.project``).
``rho`` and ``n_updates`` live on the host (a Python float that is an exact
f32 value, ramped in f32 as the JAX package ramps it, and an int), so the
train step decides when to update without a device sync.  The penalty's
gradient is computed leaf by leaf in backward (:class:`_Penalty`), so
autograd saves no f32 residual for it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...utils.tree import leaves_with_path, map_with_path
from .projections import project
from .structures import Structure, structure_from_spec

__all__ = [
    "PrunePlan",
    "AdmmConfig",
    "AdmmState",
    "admm_init",
    "admm_penalty",
    "admm_update",
    "hard_prune",
    "convergence_metrics",
]

Tree = Any


# --------------------------------------------------------------------------- #
# plan: which leaves get which structure                                       #
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class PrunePlan:
    """Maps parameter paths (glob patterns over ``keystr`` paths, see
    ``utils.tree``) to structures.  First matching rule wins; unmatched
    leaves stay dense.

    Example::

        plan = PrunePlan.from_rules([
            ("*ffn*w_in*",  {"kind": "column", "sparsity": 0.6}),
            ("*attn*",      {"kind": "block", "sparsity": 0.5, "bm": 128, "bn": 128}),
        ])
    """

    rules: Tuple[Tuple[str, Structure], ...]
    #: leaves with fewer elements than this are never pruned (norms, biases)
    min_size: int = 4096

    @classmethod
    def from_rules(cls, rules: List[Tuple[str, Any]], min_size: int = 4096) -> "PrunePlan":
        out = []
        for pat, spec in rules:
            st = spec if isinstance(spec, Structure) else structure_from_spec(spec)
            out.append((pat, st))
        return cls(tuple(out), min_size)

    @staticmethod
    def _glob_match(path: str, pat: str) -> bool:
        """Glob where ONLY ``*`` is special -- fnmatch would treat the
        ``['w']`` brackets of tree key paths as character classes."""
        rx = ".*".join(re.escape(part) for part in pat.split("*"))
        return re.search(f"^{rx}$", path) is not None

    def structure_for(self, path: str, shape: Tuple[int, ...]) -> Optional[Structure]:
        size = 1
        for d in shape:
            size *= d
        if size < self.min_size:
            return None
        for pat, st in self.rules:
            if self._glob_match(path, pat):
                try:
                    st.validate(shape)
                except ValueError:
                    return None  # structure does not fit this leaf; skip
                return st
        return None

    def assign(self, params: Tree) -> Dict[str, Structure]:
        """Resolved {path: structure} over a params tree (diagnostics/tests)."""
        out = {}
        for name, w in leaves_with_path(params):
            st = self.structure_for(name, tuple(w.shape))
            if st is not None:
                out[name] = st
        return out


@dataclasses.dataclass(frozen=True)
class AdmmConfig:
    rho: float = 1e-3
    #: multiply rho by this factor at every Z/U update (classic rho ramp)
    rho_ramp: float = 1.0
    rho_max: float = 1e-1
    #: run the Z/U update every this many optimizer steps
    update_every: int = 100


# --------------------------------------------------------------------------- #
# state                                                                        #
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class AdmmState:
    """ADMM state.  ``z``/``u`` mirror params with None on dense leaves.

    ``structures`` is static metadata, not part of the tree (checkpoints
    leave it out): {path: Structure}.
    """

    z: Tree
    u: Tree
    rho: float  # an exact f32 value
    n_updates: int
    structures: Dict[str, Structure] = dataclasses.field(
        metadata=dict(static=True), default_factory=dict
    )


def _f32(x: float) -> float:
    return float(np.float32(x))


def admm_init(params: Tree, plan: PrunePlan, config: AdmmConfig) -> AdmmState:
    """Z starts at the projection of W, U at zero (standard initialization)."""
    structures = plan.assign(params)

    def init_z(name, w):
        st = structures.get(name)
        return None if st is None else project(w.float(), st)[0]

    def init_u(name, w):
        if structures.get(name) is None:
            return None
        return torch.zeros_like(w, dtype=torch.float32)

    return AdmmState(
        z=map_with_path(init_z, params),
        u=map_with_path(init_u, params),
        rho=_f32(config.rho),
        n_updates=0,
        structures=structures,
    )


def _pruned(params: Tree, state: AdmmState):
    """``[(w, z, u)]`` of the pruned leaves, in leaf order."""
    out = []

    def visit(_, w, z, u):
        if z is not None:
            out.append((w, z, u))

    map_with_path(visit, params, state.z, state.u)
    return out


class _Penalty(torch.autograd.Function):
    """``rho * sum_i 0.5 * ||w_i - z_i + u_i||^2`` over the pruned leaves.

    Forward keeps no ``d = w - z + u``: backward recomputes it leaf by leaf
    and returns ``rho * g * d`` in each weight's dtype, the cotangent the
    JAX package's autodiff gives (``0.5 * (2 d)`` is exact)."""

    @staticmethod
    def forward(ctx, rho, zs, us, *ws):
        ctx.rho, ctx.zs, ctx.us = rho, zs, us
        ctx.save_for_backward(*ws)
        total = None
        for w, z, u in zip(ws, zs, us):
            d = w.float() - z + u
            t = 0.5 * torch.sum(d * d)
            total = t if total is None else total + t
        return rho * total

    @staticmethod
    def backward(ctx, g):
        scale = g * ctx.rho
        grads = tuple(((w.float() - z + u) * scale).to(w.dtype)
                      for w, z, u in zip(ctx.saved_tensors, ctx.zs, ctx.us))
        return (None, None, None) + grads


def admm_penalty(params: Tree, state: AdmmState) -> torch.Tensor:
    """``rho/2 * sum_i ||W_i - Z_i + U_i||_F^2`` -- add to the task loss."""
    triples = _pruned(params, state)
    if not triples:
        return torch.zeros((), dtype=torch.float32)
    ws, zs, us = zip(*triples)
    return _Penalty.apply(state.rho, zs, us, *ws)


@torch.no_grad()
def admm_update(params: Tree, state: AdmmState, config: AdmmConfig) -> AdmmState:
    """Z-step (projection) + U-step (dual ascent) + rho ramp.  U is updated
    in place (``(u + w) - z``, the JAX package's rounding); the returned
    state holds new Z tensors."""

    def new_z(name, w, u):
        if u is None:
            return None
        return project(w.float() + u, state.structures[name])[0]

    z = map_with_path(new_z, params, state.u)

    def new_u(name, w, zi, u):
        if u is None:
            return None
        return u.add_(w.float()).sub_(zi)

    u = map_with_path(new_u, params, z, state.u)
    rho = _f32(min(np.float32(state.rho) * np.float32(config.rho_ramp),
                   np.float32(config.rho_max)))
    return AdmmState(z=z, u=u, rho=rho, n_updates=state.n_updates + 1,
                     structures=state.structures)


@torch.no_grad()
def hard_prune(params: Tree, state: AdmmState) -> Tuple[Tree, Tree]:
    """Final projection: returns (pruned_params, mask_tree) for masked
    retrain; the masks are f32, ``None`` on dense leaves."""
    pruned, masks = {}, {}

    def prune(name, w):
        st = state.structures.get(name)
        if st is None:
            pruned[name], masks[name] = w, None
        else:
            wp, m = project(w, st)
            pruned[name], masks[name] = wp.to(w.dtype), m.float()

    map_with_path(prune, params)
    return (map_with_path(lambda name, _: pruned[name], params),
            map_with_path(lambda name, _: masks[name], params))


@torch.no_grad()
def convergence_metrics(params: Tree, state: AdmmState) -> Dict[str, Any]:
    """Primal residual ``||W - Z|| / ||W||`` (global, a device scalar; no
    host sync); drives stop criteria."""
    num = den = None
    for w, z, _ in _pruned(params, state):
        wf = w.float()
        a, b = torch.sum((wf - z) ** 2), torch.sum(wf * wf)
        num, den = (a, b) if num is None else (num + a, den + b)
    if num is None:
        num = den = torch.zeros((), dtype=torch.float32)
    res = torch.sqrt(num) / torch.clamp(torch.sqrt(den), min=1e-12)
    return {"primal_residual": res, "rho": state.rho}
