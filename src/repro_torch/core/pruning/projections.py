"""Euclidean projections onto the structured-sparsity sets (a port of
``repro.core.pruning.projections``: all eight sets of structures.py).

The ADMM Z-step is ``Z = Pi_S(W + U)`` -- the closest point (Frobenius norm)
in the structure set.  For every magnitude-type structure this is "keep the
largest-magnitude prune-units, zero the rest", with the unit's magnitude
pooled as the group L2 norm.  Every projection returns ``(projected, mask)``
with ``mask`` broadcastable to the weight shape.  The reduction shapes (a
block's norm is pooled in f32), the pattern argmax (first maximum wins) and
``topk_mask``'s stable double argsort follow the JAX code, so masks agree
bit for bit.

Shapes follow structures.py: 2-D ``W[K, N]`` for matrix structures, 4-D
``W[C_out, C_in, kh, kw]`` for PatternKernel.

A DTensor leaf (params on a mesh) is projected whole: gathered to every
rank, projected as above and cut back to its placements
(``models.sharding.on_whole``), so its mask is the whole leaf's bit for bit
under any rules -- JAX's ``project`` on a sharded array is the same
function.  That costs one f32 leaf on each rank while it runs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .structures import (
    NM,
    BankBalanced,
    Block,
    Channel,
    Column,
    PatternKernel,
    Row,
    Structure,
    Unstructured,
)

__all__ = ["project", "mask_for", "topk_mask"]


def topk_mask(scores: torch.Tensor, k: int, axis: int = -1) -> torch.Tensor:
    """0/1 mask keeping the top-``k`` entries of ``scores`` along ``axis``,
    ties broken by index (exactly ``k`` survive)."""
    if k <= 0:
        return torch.zeros_like(scores)
    n = scores.shape[axis]
    if k >= n:
        return torch.ones_like(scores)
    moved = scores.movedim(axis, -1)
    kth = torch.topk(moved, k, dim=-1).values[..., -1:]
    keep = moved >= kth
    order = torch.argsort(
        torch.argsort(-moved, dim=-1, stable=True), dim=-1, stable=True
    )
    keep = keep & (order < k)
    return keep.to(scores.dtype).movedim(-1, axis)


def _project_unstructured(w: torch.Tensor, s: Unstructured) -> Tuple[torch.Tensor, torch.Tensor]:
    mask = topk_mask(w.abs().reshape(-1), s.n_kept(w.numel())).reshape(w.shape)
    return w * mask, mask


def _project_row(w: torch.Tensor, s: Row) -> Tuple[torch.Tensor, torch.Tensor]:
    norms = torch.linalg.norm(w, dim=1)  # [K]
    mask = topk_mask(norms, s.n_kept(w.shape[0]))[:, None]
    return w * mask, mask.expand(w.shape)


def _project_column(w: torch.Tensor, s: Column) -> Tuple[torch.Tensor, torch.Tensor]:
    # prune along the input-feature axis (axis 0 of W[K, N]): the same
    # position removed from every output filter
    norms = torch.linalg.norm(w, dim=1)  # [K]
    mask = topk_mask(norms, s.n_kept(w.shape[0]))[:, None]
    return w * mask, mask.expand(w.shape)


def _project_channel(w: torch.Tensor, s: Channel) -> Tuple[torch.Tensor, torch.Tensor]:
    norms = torch.linalg.norm(w, dim=0)  # [N]
    mask = topk_mask(norms, s.n_kept(w.shape[1]))[None, :]
    return w * mask, mask.expand(w.shape)


def _project_block(w: torch.Tensor, s: Block) -> Tuple[torch.Tensor, torch.Tensor]:
    kb, nb = s.grid(w.shape)
    blocks = w.reshape(kb, s.bm, nb, s.bn)
    norms = torch.sqrt(torch.sum(blocks.float() ** 2, dim=(1, 3)))  # [kb, nb]
    if s.balanced:
        # the same number of kept blocks in every block-COLUMN (output
        # feature group): every output tile of the block-sparse kernel then
        # does identical work
        bmask = topk_mask(norms, s.n_kept(kb), axis=0)
    else:
        bmask = topk_mask(norms.reshape(-1), s.n_kept(kb * nb)).reshape(kb, nb)
    mask = bmask[:, None, :, None].expand(blocks.shape).reshape(w.shape).to(w.dtype)
    return w * mask, mask


def _project_nm(w: torch.Tensor, s: NM) -> Tuple[torch.Tensor, torch.Tensor]:
    k, n = w.shape
    groups = w.reshape(k // s.m, s.m, n)
    mask = topk_mask(groups.abs(), s.n_keep, axis=1).reshape(w.shape)
    return w * mask, mask


def _project_bank(w: torch.Tensor, s: BankBalanced) -> Tuple[torch.Tensor, torch.Tensor]:
    k, n = w.shape
    banks = w.reshape(k, n // s.bank, s.bank)
    mask = topk_mask(banks.abs(), s.n_kept(s.bank), axis=2).reshape(w.shape)
    return w * mask, mask


def _pattern_library(s: PatternKernel) -> np.ndarray:
    """[P, kh*kw] 0/1 library matrix (static, numpy)."""
    ksz = s.kernel_size * s.kernel_size
    lib = np.zeros((len(s.patterns), ksz), np.float32)
    for i, pat in enumerate(s.patterns):
        lib[i, list(pat)] = 1.0
    return lib


def _project_pattern(w: torch.Tensor, s: PatternKernel) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pattern + connectivity projection for conv weights [C_out, C_in, kh, kw].

    Per kernel: pick the library pattern retaining the most energy, zero the
    rest of the kernel.  Then cut the ``connectivity`` fraction of kernels
    with the smallest retained energy (whole-kernel removal)."""
    co, ci, kh, kw = w.shape
    lib = torch.from_numpy(_pattern_library(s)).to(w.device)  # [P, ksz]
    energy = w.reshape(co, ci, kh * kw).float() ** 2  # [co, ci, ksz]
    retained = torch.einsum("oik,pk->oip", energy, lib)  # [co, ci, P]
    best = torch.argmax(retained, dim=-1)  # [co, ci]
    kmask = lib[best]  # [co, ci, ksz]
    if s.connectivity > 0.0:
        kept_energy = retained.max(dim=-1).values  # [co, ci]
        n_keep = max(1, int(round(ci * co * (1.0 - s.connectivity))))
        conn = topk_mask(kept_energy.reshape(-1), n_keep).reshape(co, ci)
        kmask = kmask * conn[..., None]
    mask = kmask.reshape(w.shape).to(w.dtype)
    return w * mask, mask


_DISPATCH = {
    Unstructured: _project_unstructured,
    Row: _project_row,
    Column: _project_column,
    Channel: _project_channel,
    Block: _project_block,
    NM: _project_nm,
    BankBalanced: _project_bank,
    PatternKernel: _project_pattern,
}


def project(w: torch.Tensor, structure: Structure) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euclidean projection of ``w`` onto ``structure``; returns (w_proj, mask)
    (DTensors of ``w``'s placements when ``w`` is one)."""
    structure.validate(tuple(w.shape))
    from ...models.sharding import is_dtensor, on_whole  # models import this package

    if is_dtensor(w):
        return on_whole(lambda t: project(t, structure), w)
    try:
        fn = _DISPATCH[type(structure)]
    except KeyError:
        raise NotImplementedError(f"no projection for {type(structure).__name__}") from None
    return fn(w, structure)


def mask_for(w: torch.Tensor, structure: Structure) -> torch.Tensor:
    """Just the 0/1 mask of the projection (same dtype as ``w``)."""
    return project(w, structure)[1]
