"""Overlapped collective matmuls over a tensor-parallel axis (a port of
``repro.training.collective_matmul``).

``ag_matmul`` computes ``all_gather(x) @ w`` without an all-gather before
the product: each of the N ring steps multiplies the resident x-chunk while
the next chunk is in flight to the next rank (``dist.batch_isend_irecv``,
posted before the matmul and waited after it), so (N-1)/N of the traffic
can hide behind the matmuls -- the Wang et al. / Megatron decomposition.

``rs_matmul`` is the reverse (matmul + reduce-scatter): each step adds the
partial product for the shard the running f32 buffer will end on and
passes the buffer on; the next step's product is computed while the buffer
travels.  Together they are the overlapped TP pair (column-parallel in,
row-parallel out).  Each is an autograd ``Function`` whose backward is the
other ring: d ``ag`` / dx is an ``rs`` with ``w_local.T``, d ``rs`` / dx an
``ag``; dW comes from the gathered operand.

The JAX package writes them in ``shard_map`` with ``ppermute``; here they
are per-rank code on the axis's process group.  The matmul itself is
``torch.matmul``, as JAX's is ``jnp.dot`` (no kernel of either package).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

__all__ = ["ag_matmul", "rs_matmul", "make_overlapped_tp_matmuls"]


class _Ring:
    """This rank's place on the axis's ring and the P2P step to the next."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        self.idx = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.idx + 1) % self.n)
        self.prev = dist.get_global_rank(group, (self.idx - 1) % self.n)

    def start(self, send: torch.Tensor, recv: torch.Tensor) -> List:
        """Post ``send`` to the next rank and ``recv`` from the previous."""
        return dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, self.next, self.group),
            dist.P2POp(dist.irecv, recv, self.prev, self.group),
        ])


def _wait(reqs) -> None:
    for r in reqs:
        r.wait()


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in f32 (``preferred_element_type=f32``)."""
    return torch.matmul(a.float(), b.float()) if a.dtype != torch.float32 else a @ b


def _ag_ring(x_local: torch.Tensor, w_local: torch.Tensor, ring: _Ring
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(concat_i(x_i) @ w_local, concat_i(x_i))``, by the ring."""
    m_loc = x_local.shape[0]
    out = x_local.new_empty((ring.n * m_loc, w_local.shape[1]))
    gathered = x_local.new_empty((ring.n * m_loc, x_local.shape[1]))
    chunk, src = x_local.contiguous(), ring.idx
    for step in range(ring.n):
        reqs = []
        if step < ring.n - 1:  # the next chunk travels while this one multiplies
            nxt = torch.empty_like(chunk)
            reqs = ring.start(chunk, nxt)
        rows = slice(src * m_loc, (src + 1) * m_loc)
        out[rows] = _dot(chunk, w_local).to(out.dtype)
        gathered[rows] = chunk
        _wait(reqs)
        if reqs:
            chunk, src = nxt, (src - 1) % ring.n
    return out, gathered


def _rs_ring(x_local: torch.Tensor, w_local: torch.Tensor, ring: _Ring) -> torch.Tensor:
    """This rank's row shard of ``sum_ranks(x_local @ w_local)``."""
    m_loc = x_local.shape[0] // ring.n

    def piece(i):  # the partial for the shard the buffer ends on after step i
        tgt = (ring.idx + (ring.n - 1 - i)) % ring.n
        return _dot(x_local[tgt * m_loc:(tgt + 1) * m_loc], w_local)

    acc = piece(0)
    for i in range(1, ring.n):
        buf = torch.empty_like(acc)
        reqs = ring.start(acc.contiguous(), buf)
        p = piece(i)  # overlaps the buffer's hop
        _wait(reqs)
        acc = buf + p
    return acc.to(x_local.dtype)


class _AgMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_local, w_local, ring):
        out, gathered = _ag_ring(x_local, w_local, ring)
        ctx.save_for_backward(gathered, w_local)
        ctx.ring = ring
        return out

    @staticmethod
    def backward(ctx, g):
        gathered, w_local = ctx.saved_tensors
        dx = _RsMatmul.apply(g, w_local.t(), ctx.ring) if ctx.needs_input_grad[0] else None
        dw = (gathered.t() @ g) if ctx.needs_input_grad[1] else None
        return dx, dw, None


class _RsMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_local, w_local, ring):
        ctx.save_for_backward(x_local, w_local)
        ctx.ring = ring
        return _rs_ring(x_local, w_local, ring)

    @staticmethod
    def backward(ctx, g):
        x_local, w_local = ctx.saved_tensors
        dx, g_full = _ag_ring(g, w_local.t(), ctx.ring)
        dw = (x_local.t() @ g_full) if ctx.needs_input_grad[1] else None
        return (dx if ctx.needs_input_grad[0] else None), dw, None


def ag_matmul(x_local: torch.Tensor, w_local: torch.Tensor, group) -> torch.Tensor:
    """``concat_i(x_i) @ w_local`` over ``group``'s ring.

    x_local: [m_loc, k] (this rank's row shard of X)
    w_local: [k, n_loc] (this rank's column shard of W)
    returns: [m_loc * N, n_loc] (all X rows against the local W columns)
    """
    return _AgMatmul.apply(x_local, w_local, _Ring(group))


def rs_matmul(x_local: torch.Tensor, w_local: torch.Tensor, group) -> torch.Tensor:
    """``reduce_scatter(x_full_rows @ w_local, rows)`` over ``group``'s ring.

    x_local: [m, k_loc] (full rows, K sharded)  w_local: [k_loc, n]
    returns: [m / N, n] (this rank's row shard of the summed product)
    """
    return _RsMatmul.apply(x_local, w_local, _Ring(group))


def make_overlapped_tp_matmuls(mesh, axis_name: str = "model"):
    """The pair on DTensors of ``mesh``, as the JAX package's ``shard_map``
    pair on global arrays::

        ag(x [M, K] Shard(0) over axis, w [K, N] Shard(1)) -> y [M, N] Shard(1)
        rs(x [M, K] Shard(1) over axis, w [K, N] Shard(0)) -> y [M, N] Shard(0)

    (replicated over the mesh's other axes).  Inputs are redistributed to
    those placements first."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    d = mesh.mesh_dim_names.index(axis_name)
    group = mesh.get_group(axis_name)

    def placed(dim):
        return [Shard(dim) if i == d else Replicate() for i in range(mesh.ndim)]

    def wrap(fn, x_dim, w_dim, out_dim):
        def run(x: DTensor, w: DTensor) -> DTensor:
            xl = x.redistribute(mesh, placed(x_dim)).to_local()
            wl = w.redistribute(mesh, placed(w_dim)).to_local()
            return DTensor.from_local(fn(xl, wl, group), mesh, placed(out_dim))
        return run

    return wrap(ag_matmul, 0, 1, 1), wrap(rs_matmul, 1, 0, 0)
