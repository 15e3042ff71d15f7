"""Path-pattern -> partition-spec rules on ``torch.distributed`` DTensors (a
port of ``repro.models.sharding``).

Tensor-parallel layout over the ``model`` mesh axis; batch over
``("pod", "data")`` (or ``("data",)`` on one pod).  Rules are ordered; the
first regex that matches a leaf's path (``utils.tree.leaves_with_path``,
spelled as ``jax.tree_util.keystr``) wins.  Anything unmatched is
replicated -- the safe default for norms and scalars.

A spec is a :class:`PartitionSpec`: one entry a tensor dim, each ``None``
(replicated), a mesh axis name, or a tuple of names (the dim split over
those axes, the first the major one).  ``param_placements`` turns a spec
into DTensor placements, one a mesh dim; ``distribute_params`` places a
param tree on a mesh, where JAX's ``NamedSharding`` + ``device_put`` do.
``cache_pspecs`` lays decode caches out as the JAX package's dry run does
(batch over the data axes, the long axis over ``model``), ``place_cache``
puts a layer's cache there and ``place_rows`` cuts a batch every rank holds
(a prompt, a sampled token) over the batch axes; ``broadcast_row`` and
``splice_row`` fill a batched cache from one-row prefills (continuous
batching), each rank writing only the rows it holds.

The helpers at the end are what GSPMD does for the JAX package inside the
model code: ``mesh_context`` (a constant the model builds -- rope tables,
masks, positions -- is replicated on every rank), ``constrain``
(``with_sharding_constraint``), ``embedding`` (a vocab-sharded lookup and
its all-reduce), ``head_operands`` (the LM head's logits split over the
vocab), ``logsumexp_pick`` (the vocab-parallel cross entropy),
``reduce_partial``, ``replicate_axis`` and ``whole_if_uneven`` (gathering a
tensor dim before an op that needs it whole, or evenly cut).  Some work runs
on each rank's shard instead,
where DTensor has no sharding rule for an op (``scatter_reduce``), leaves a
partial it cannot reduce (``gather``), or takes views and pads in one
PyTorch version that it refuses in another (2.13 against the card's 2.11):
``attention_on_shards`` (batch rows and heads), ``split_last`` /
``merge_last`` (the head reshapes), ``on_rows`` (MoE dispatch),
``on_mixer`` (the Mamba-2 and RG-LRU mixers and their decode steps on each
rank's heads or channels: input projections cut by columns, the output
projection by rows, the recurrent state where it lies), ``on_experts``
(the MoE expert stacks, gathered over ``data`` under ``FSDP_RULES`` as
GSPMD gathers an FSDP weight), ``on_heads`` (MLA's absorbed projections),
``on_cache`` (a decode step's attention on each rank's slots of its cache,
combined over ``model`` as flash-decoding's split-K: no rank gathers a
cache), ``on_sequence`` (a prefill's cache filled on each rank's rows and
heads) and ``gather_last``.  ``on_whole`` runs work that needs a tensor
whole (the ADMM projections' global top-k, the micro-batch split of a
batch) on the gathered tensor and cuts the result back to the tensor's
placements, each rank keeping its chunk; ``placed_like`` redistributes a
tree to the placements of another (MLA's absorbed context onto the
query's heads).  On plain tensors each of them is the plain op.
"""

from __future__ import annotations

import contextlib
import math
import re
import threading
from typing import Any, Iterator, List, Optional, Tuple

import torch

from ..utils.tree import leaves, map_with_path, tree_map

__all__ = [
    "PartitionSpec",
    "P",
    "DEFAULT_RULES",
    "FSDP_RULES",
    "param_pspecs",
    "param_placements",
    "NamedSharding",
    "param_shardings",
    "distribute_params",
    "batch_spec",
    "cache_pspecs",
    "place_rows",
    "place_cache",
    "broadcast_row",
    "splice_row",
    "is_dtensor",
    "mesh_context",
    "constrain",
    "reduce_partial",
    "embedding",
    "replicate_axis",
    "whole_if_uneven",
    "gather_last",
    "logsumexp_pick",
    "head_operands",
    "on_rows",
    "MixerCut",
    "WHOLE",
    "on_mixer",
    "on_experts",
    "on_heads",
    "on_cache",
    "on_sequence",
    "placed_like",
    "attention_on_shards",
    "split_last",
    "merge_last",
    "on_whole",
]

Tree = Any


class PartitionSpec:
    """A tuple of per-dim entries (``None``, an axis name or a tuple of
    names); a tree leaf, not a container."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(tuple(p) if isinstance(p, list) else p for p in parts)

    def __iter__(self) -> Iterator:
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self._parts == other._parts

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._parts!r}"

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes tensor dim ``dim`` is split over (major first)."""
        e = self._parts[dim] if dim < len(self._parts) else None
        if e is None:
            return ()
        return e if isinstance(e, tuple) else (e,)


P = PartitionSpec

# (regex, spec) -- specs name the "model" TP axis only; the batch axes never
# appear in parameter specs.
DEFAULT_RULES: List[Tuple[str, P]] = [
    # embeddings / unembedding: vocab-sharded
    (r"\['embed'\].*table", P("model", None)),
    (r"\['lm_head'\].*\['w'\]", P(None, "model")),
    # MoE expert stacks [E, D, F]: expert-parallel
    (r"\['experts'\]\['w_gate'\]", P("model", None, None)),
    (r"\['experts'\]\['w_up'\]", P("model", None, None)),
    (r"\['experts'\]\['w_down'\]", P("model", None, None)),
    (r"\['router'\]", P(None)),
    # attention: heads over model
    (r"\['(w_q|w_k|w_v|w_uq|w_uk|w_uv)'\]\['w'\]", P(None, "model")),
    (r"\['(w_q|w_k|w_v|w_uq|w_uk|w_uv)'\]\['b'\]", P("model")),
    (r"\['w_o'\]\['w'\]", P("model", None)),
    (r"\['(w_dq|w_dkv|w_kr)'\]\['w'\]", P(None, None)),  # small latent projs
    # gated FFN: column-parallel in, row-parallel out
    (r"\['(w_gate|w_up|in_proj|gate_proj|w_r|w_i)'\]\['w'\]", P(None, "model")),
    (r"\['(w_gate|w_up|in_proj|gate_proj|w_r|w_i)'\]\['b'\]", P("model")),
    (r"\['(w_down|out_proj)'\]\['w'\]", P("model", None)),
    # packed sparse weights: PBCSR values [Nb, S, bm, bn] -> output-column
    # sharded (block-cols over model); ColumnCompact values like the dense w.
    (r"\['values'\]", P("model", None, None, None)),
    (r"\['block_rows'\]", P("model", None)),
    # conv1d stems, norms, scalars: replicated
]

# FSDP variant: weights also sharded over ``data`` so the largest configs
# fit a card's HBM; DTensor all-gathers the shards where they are used.
FSDP_RULES: List[Tuple[str, P]] = [
    (r"\['embed'\].*table", P("model", "data")),
    (r"\['lm_head'\]\['w'\]", P("data", "model")),
    (r"\['experts'\]\['w_gate'\]", P("model", "data", None)),
    (r"\['experts'\]\['w_up'\]", P("model", "data", None)),
    (r"\['experts'\]\['w_down'\]", P("model", "data", None)),
    (r"\['router'\]", P(None)),
    (r"\['(w_q|w_k|w_v|w_uq|w_uk|w_uv)'\]\['w'\]", P("data", "model")),
    (r"\['(w_q|w_k|w_v|w_uq|w_uk|w_uv)'\]\['b'\]", P("model")),
    (r"\['w_o'\]\['w'\]", P("model", "data")),
    (r"\['(w_dq|w_dkv|w_kr)'\]\['w'\]", P("data", None)),
    (r"\['(w_gate|w_up|in_proj|gate_proj|w_r|w_i)'\]\['w'\]", P("data", "model")),
    (r"\['(w_gate|w_up|in_proj|gate_proj|w_r|w_i)'\]\['b'\]", P("model")),
    (r"\['(w_down|out_proj)'\]\['w'\]", P("model", "data")),
    (r"\['values'\]", P("model", None, None, None)),
    (r"\['block_rows'\]", P("model", None)),
]


def _spec_for(path: str, rules) -> Optional[P]:
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return None


def param_pspecs(params: Tree, rules=None) -> Tree:
    """Mirror tree of specs (``P()`` for unmatched leaves); a spec shorter
    than its leaf's rank is padded with ``None``, one longer (a 2-D rule on a
    packed 1-D leaf) replicates the leaf."""
    rules = DEFAULT_RULES if rules is None else rules

    def spec(path, leaf):
        s = _spec_for(path, rules)
        if s is None:
            return P()
        nd = getattr(leaf, "ndim", len(getattr(leaf, "shape", ())))
        if len(s) > nd:
            return P()
        return P(*s, *([None] * (nd - len(s))))

    return map_with_path(spec, params)


def param_placements(mesh, spec: P) -> List:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every mesh
    dim that tensor dim ``d`` is split over, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out: List = [Replicate() for _ in names]
    for d in range(len(spec)):
        for a in spec.axes(d):
            if a not in names:
                raise ValueError(f"{spec}: mesh axis {a!r} not in mesh {names}")
            out[names.index(a)] = Shard(d)
    return out


class NamedSharding:
    """A mesh and a spec (JAX's ``NamedSharding``); a tree leaf."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, spec

    @property
    def placements(self) -> List:
        return param_placements(self.mesh, self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.mesh_dim_names}, {self.spec})"


def param_shardings(mesh, params: Tree, rules=None) -> Tree:
    return map_with_path(lambda _, s: NamedSharding(mesh, s), param_pspecs(params, rules))


def distribute_params(mesh, params: Tree, rules=None, specs: Optional[Tree] = None) -> Tree:
    """``params`` as DTensors on ``mesh`` (each rank passes the same full
    tree; ``specs`` defaults to ``param_pspecs(params, rules)``)."""
    from torch.distributed.tensor import distribute_tensor

    specs = param_pspecs(params, rules) if specs is None else specs
    return map_with_path(
        lambda _, leaf, s: distribute_tensor(leaf, mesh, param_placements(mesh, s)),
        params, specs)


def batch_spec(mesh) -> P:
    """Batch axis spec: ``("pod", "data")`` when the pod axis exists."""
    if "pod" in mesh.mesh_dim_names:
        return P(("pod", "data"))
    return P("data")


def _cache_pspecs(cache_tree: Tree, bspec: P) -> Tree:
    """Decode-cache specs: batch over the data axes, the long axis
    (sequence / heads) over ``model`` -- flash-decoding-style split-K."""
    batch_axes = bspec[0] if len(bspec) else None

    def spec(path, leaf):
        nd = leaf.ndim
        if nd <= 1:
            return P(batch_axes) if nd == 1 else P()
        if path.endswith("['conv']"):  # [B, w-1, C]
            return P(batch_axes, None, "model")
        if nd >= 3:  # k/v/c_kv/k_rope/state: [B, S|H, ...]
            return P(batch_axes, "model", *([None] * (nd - 2)))
        return P(batch_axes, "model")  # rec h: [B, W]

    return map_with_path(spec, cache_tree)


def _maybe_replicate_batch(specs: Tree, tree: Tree, mesh) -> Tree:
    """Drop any spec axis whose mesh extent does not divide the dim
    (long_500k has global_batch=1 -> TP-only decode; whisper's cross-KV has
    T_enc=1500 which 16 does not divide -> replicated sequence)."""
    names = mesh.mesh_dim_names

    def extent(entry) -> int:
        return math.prod(mesh.size(names.index(a)) for a in
                         (entry if isinstance(entry, tuple) else (entry,)) if a is not None)

    def fix(leaf, spec):
        if not len(spec):
            return spec
        parts = list(spec) + [None] * (leaf.ndim - len(spec))
        return P(*[None if e is not None and leaf.shape[d] % extent(e) else e
                   for d, e in enumerate(parts)])

    return tree_map(fix, tree, specs)


def cache_pspecs(caches: Tree, mesh) -> Tree:
    """The specs of decode caches on ``mesh``, as the JAX package's dry run
    lays them out: batch over the data axes (``batch_spec``), the sequence
    of a KV or MLA cache, the heads of a Mamba-2 state and the channels of
    an RG-LRU ``h`` or a conv window over ``model``; an axis whose extent
    does not divide its dim is dropped (that dim stays whole)."""
    return _maybe_replicate_batch(_cache_pspecs(caches, batch_spec(mesh)), caches, mesh)


def place_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """A batch-leading plain tensor -- the same on every rank (a prompt, a
    sampled token) -- cut over ``mesh``'s batch axes, each rank keeping its
    rows (no collective); whole where the batch does not divide, and where
    it is one row (a scheduler's one-row prefill lies alike on every mesh:
    DTensor refuses to flatten a one-row dim cut over a mesh dim of one)."""
    spec = P() if t.shape[0] == 1 else _maybe_replicate_batch(
        P(*batch_spec(mesh), *([None] * (t.ndim - 1))), t, mesh)
    return _shard_like(t, mesh, param_placements(mesh, spec))


def place_cache(cache: Tree) -> Tree:
    """A layer's decode cache in its decode placements (:func:`cache_pspecs`)
    on the mesh of its DTensors: a DTensor is redistributed (nothing moves
    where it already lies so), a plain tensor -- a constant every rank
    holds, the prefill's ``pos`` -- is cut without a collective.  Without a
    DTensor, the cache as it is."""
    first = next((t for t in leaves(cache) if is_dtensor(t)), None)
    if first is None:
        return cache
    mesh = first.device_mesh

    def place(_, t, spec):
        pl = param_placements(mesh, spec)
        if not is_dtensor(t):
            return _shard_like(t, mesh, pl)
        t = reduce_partial(t)
        return t if list(t.placements) == pl else t.redistribute(mesh, pl)

    return map_with_path(place, cache, cache_pspecs(cache, mesh))


def _rows_held(n: int, mesh, placements) -> Tuple[int, int]:
    """The rows ``[lo, hi)`` of a batch-leading tensor of ``n`` rows that
    this rank holds under ``placements`` (``torch.chunk`` over each mesh
    dim that cuts the batch, DTensor's layout)."""
    lo, hi = 0, n
    for d, p in enumerate(placements):
        if p.is_shard(0):
            size = -(-(hi - lo) // mesh.size(d))
            lo = min(hi, lo + size * mesh.get_local_rank(d))
            hi = min(hi, lo + size)
    return lo, hi


def _check_row(row, mesh, placements) -> None:
    """A one-row cache leaf ``row`` must lie as a batched leaf of
    ``placements`` on ``mesh`` does off its batch: whole over each mesh dim
    that cuts the rows (replicated, or cut over a mesh dim of one), the same
    placement over every other."""
    from torch.distributed.tensor import Replicate

    def fits(d, r, p):
        if not p.is_shard(0):
            return r == p
        return r == Replicate() or (r.is_shard(0) and mesh.size(d) == 1)

    if row.device_mesh != mesh or not all(
            fits(d, r, p) for d, (r, p) in enumerate(zip(row.placements, placements))):
        raise ValueError(f"a one-row cache leaf lies {tuple(row.placements)}, off the "
                         f"batch's {tuple(placements)}")


@torch.no_grad()
def broadcast_row(row_cache: Tree, batch: int) -> Tree:
    """A layer's one-row cache (a batch-1 prefill's) as a cache of ``batch``
    rows, each a copy of the row: what a scheduler's first admission fills
    every slot with.  A leaf whose leading dim is 1 is repeated; any other
    is kept.  DTensor leaves come back in :func:`cache_pspecs`' placements
    for ``batch`` rows on their mesh: each rank repeats its cut of the row
    (whole over the batch axes) over the rows it holds -- no collective,
    nothing gathered."""
    first = next((t for t in leaves(row_cache) if is_dtensor(t)), None)
    if first is None:
        return tree_map(lambda c: torch.cat([c] * batch)
                        if c.dim() > 0 and c.shape[0] == 1 else c, row_cache)
    mesh = first.device_mesh
    template = tree_map(lambda c: torch.empty((batch, *c.shape[1:]), dtype=c.dtype,
                                              device="meta")
                        if c.dim() > 0 and c.shape[0] == 1 else c, row_cache)

    def place(_, c, spec):
        if c.dim() == 0 or c.shape[0] != 1:
            return c
        pl = param_placements(mesh, spec)
        _check_row(c, mesh, pl)
        lo, hi = _rows_held(batch, mesh, pl)
        local = c.to_local()
        return _placed(local.expand(hi - lo, *local.shape[1:]).contiguous(), mesh, pl,
                       (batch, *c.shape[1:]))

    return map_with_path(place, row_cache, cache_pspecs(template, mesh))


@torch.no_grad()
def splice_row(full_cache: Tree, row_cache: Tree, i: int) -> Tree:
    """Row 0 of a layer's one-row cache written into row ``i`` of its
    batched cache, in place (every leaf with a leading dim).  On DTensors
    the rank or ranks holding row ``i`` write their cut of the row into
    their local row ``i - lo``; the others do nothing -- no collective.  A
    row leaf that lies other than the batched leaf off the batch raises."""
    for full, row in zip(leaves(full_cache), leaves(row_cache)):
        if full.dim() == 0:
            continue
        if not is_dtensor(full):
            full[i] = row[0]
            continue
        _check_row(row, full.device_mesh, full.placements)
        lo, hi = _rows_held(full.shape[0], full.device_mesh, full.placements)
        if lo <= i < hi:
            full.to_local()[i - lo] = row.to_local()[0]
    return full_cache


# --------------------------------------------------------------------------- #
# what GSPMD inserts inside the model code                                    #
# --------------------------------------------------------------------------- #


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, spec: Optional[P]) -> torch.Tensor:
    """``x`` redistributed to ``spec`` on its own mesh (JAX's
    ``with_sharding_constraint``); a plain tensor, or ``spec=None``, as is."""
    if spec is None or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, param_placements(x.device_mesh, spec))


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending (partial) reductions carried out: every
    ``Partial`` placement becomes ``Replicate`` (a vocab-sharded embedding
    lookup leaves one over ``model``)."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh,
                          [Replicate() if p.is_partial() else p for p in x.placements])


def replicate_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor with tensor dim ``dim`` whole on every rank (the mesh dims
    sharding it become ``Replicate``)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    dim = dim % x.ndim
    pl = [Replicate() if p.is_shard() and p.dim % x.ndim == dim else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)


def whole_if_uneven(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """A DTensor with each tensor dim of ``dims`` made whole on every rank
    where the mesh dims cutting it do not divide it (DTensor's views take
    only even cuts, and its matmuls may cut a batch or a sequence unevenly
    over a mesh dim the batch leaves free); an even cut, or a plain tensor,
    as it is."""
    if not is_dtensor(x):
        return x
    for dim in dims:
        dim = dim % x.ndim
        n = math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                      if p.is_shard() and p.dim % x.ndim == dim)
        if x.shape[dim] % n:
            x = replicate_axis(x, dim)
    return x


class _Nesting:
    """Depth of nested :func:`mesh_context` blocks.  DTensor's
    ``implicit_replication`` sets one process-wide flag and clears it on
    exit, so only the outermost block may enter it."""

    def __init__(self):
        self.lock = threading.Lock()
        self.depth = 0
        self.ctx = None

    def enter(self) -> None:
        with self.lock:
            if self.depth == 0:
                from torch.distributed.tensor.experimental import implicit_replication

                self.ctx = implicit_replication()
                self.ctx.__enter__()
            self.depth += 1

    def exit(self) -> None:
        with self.lock:
            self.depth -= 1
            if self.depth == 0:
                ctx, self.ctx = self.ctx, None
                ctx.__exit__(None, None, None)


_NESTING = _Nesting()


@contextlib.contextmanager
def mesh_context(*trees):
    """Inside, a plain tensor that meets a DTensor counts as replicated on
    the DTensor's mesh (the constants the model code builds: positions, rope
    tables, masks); entered only when a leaf of ``trees`` is a DTensor, so a
    plain run sees nothing.  Nests; the backward of a step whose forward
    ran inside must run inside too (autograd saved those constants)."""
    if not any(is_dtensor(x) for x in leaves(trees)):
        yield
        return
    _NESTING.enter()
    try:
        yield
    finally:
        _NESTING.exit()


def gather_last(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, index)``.  On a DTensor the last dim is made
    whole and the gather runs on each rank's local shard, ``index`` placed
    as ``x`` (DTensor's own gather strategy leaves a masked partial that a
    later op cannot reduce)."""
    if not is_dtensor(x):
        return torch.gather(x, -1, index)
    from torch.distributed.tensor import DTensor, distribute_tensor

    x = replicate_axis(reduce_partial(x), -1)
    mesh, pl = x.device_mesh, x.placements
    index = (index.redistribute(mesh, pl) if is_dtensor(index)
             else distribute_tensor(index, mesh, pl))
    return DTensor.from_local(torch.gather(x.to_local(), -1, index.to_local()), mesh, pl)


def on_rows(fn, *rows):
    """``fn(*rows)`` on each rank's batch rows: every DTensor in the
    ``rows`` (tensors or trees of them, batch-leading) is placed as the
    first one with only its dim-0 shards kept (its pending reductions
    carried out), and every tensor in what ``fn`` returns is a DTensor of
    the rows' placements.  For work that is row-wise over the batch and has
    no weights: MoE's dispatch.  Without a DTensor row, the plain call."""
    first = next((t for t in leaves(rows) if is_dtensor(t)), None)
    if first is None:
        return fn(*rows)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = first.device_mesh
    pl = [p if p.is_shard() and p.dim == 0 else Replicate() for p in first.placements]
    local = [tree_map(lambda t: t.redistribute(mesh, pl).to_local() if is_dtensor(t) else t, a)
             for a in rows]
    return tree_map(lambda t: DTensor.from_local(t, mesh, pl)
                    if isinstance(t, torch.Tensor) else t, fn(*local))


def embedding(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``.  A DTensor table is looked up as
    Megatron's vocab-parallel embedding: on a mesh dim that shards the table's
    rows and not the tokens, each rank looks up the tokens of its row range
    (the others read zero) and the partial rows are all-reduced -- GSPMD's
    lowering of JAX's gather on a ``P("model", None)`` table.  Shards of the
    table's other dim (FSDP rules) are gathered first."""
    if not is_dtensor(table):
        return torch.nn.functional.embedding(tokens, table)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = distribute_tensor(tokens, mesh, [Replicate()] * mesh.ndim)
    tok_pl = [p if p.is_shard() and p.dim == 0 else Replicate() for p in tokens.placements]
    tab_pl, out_pl, grad_pl, vocab_dims = [], [], [], []
    for i, (t, w) in enumerate(zip(tok_pl, table.placements)):
        rows = w.is_shard() and w.dim == 0 and not t.is_shard() and not vocab_dims
        if rows:
            vocab_dims.append(i)
        tab_pl.append(Shard(0) if rows else Replicate())
        out_pl.append(Partial() if rows else t)
        # each rank's table gradient is its own tokens' share
        grad_pl.append(Shard(0) if rows else (Partial() if t.is_shard() else Replicate()))
    w_local = table.redistribute(mesh, tab_pl).to_local(grad_placements=grad_pl)
    tok_local = tokens.redistribute(mesh, tok_pl).to_local()
    if vocab_dims:
        d = vocab_dims[0]
        per = -(-table.shape[0] // mesh.size(d))  # torch.chunk's rows a shard
        lo = mesh.get_local_rank(d) * per
        inside = (tok_local >= lo) & (tok_local < lo + w_local.shape[0])
        idx = torch.where(inside, tok_local - lo, torch.zeros_like(tok_local))
        out = torch.nn.functional.embedding(idx, w_local) * inside[..., None].to(w_local.dtype)
    else:
        out = torch.nn.functional.embedding(tok_local, w_local)
    return reduce_partial(DTensor.from_local(out, mesh, out_pl))


def logsumexp_pick(x: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(torch.logsumexp(x, -1), x[..., labels])``.  When a DTensor ``x``
    is split over its last dim (vocab-sharded logits), each rank reduces its
    shard and the partial results are all-reduced (Megatron's vocab-parallel
    cross entropy, what GSPMD makes of JAX's ``logsumexp``): the logits are
    never gathered whole.  The max each rank subtracts is a constant of the
    gradient."""
    vocab = [i for i, p in enumerate(x.placements) if p.is_shard() and p.dim % x.ndim == x.ndim - 1
             and x.device_mesh.size(i) > 1] if is_dtensor(x) else []
    if not vocab:
        return torch.logsumexp(x, dim=-1), gather_last(x, labels[..., None])[..., 0]
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, distribute_tensor

    x = reduce_partial(x)
    mesh = x.device_mesh
    rows_pl = [Replicate() if i in vocab else p for i, p in enumerate(x.placements)]
    labels = (labels.redistribute(mesh, rows_pl) if is_dtensor(labels)
              else distribute_tensor(labels, mesh, rows_pl))
    part_pl = [Partial() if i in vocab else p for i, p in enumerate(rows_pl)]
    local, lab = x.to_local(), labels.to_local()
    m = local.detach().amax(dim=-1)
    for i in vocab:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group(i))
    sumexp = torch.exp(local - m[..., None]).sum(dim=-1)
    lse = DTensor.from_local(sumexp, mesh, part_pl).redistribute(mesh, rows_pl).log() \
        + DTensor.from_local(m, mesh, rows_pl)
    # this shard's columns: [lo, lo + width) of the vocab
    (d,) = vocab[:1] if len(vocab) == 1 else (None,)
    if d is None:
        raise ValueError(f"logsumexp_pick: vocab split over several mesh dims {vocab}")
    width = local.shape[-1]
    lo = mesh.get_local_rank(d) * -(-x.shape[-1] // mesh.size(d))
    inside = (lab >= lo) & (lab < lo + width)
    idx = torch.where(inside, lab - lo, torch.zeros_like(lab))
    picked = torch.gather(local, -1, idx.long()[..., None])[..., 0] * inside.to(local.dtype)
    return lse, DTensor.from_local(picked, mesh, part_pl).redistribute(mesh, rows_pl)


def head_operands(x: torch.Tensor, w: torch.Tensor, vocab_dim: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x, w)`` placed for an LM head's product (``x [B, S, D]``, the
    classes of ``w`` on its dim ``vocab_dim``), so that the logits come out
    split over the vocab on every mesh dim that splits ``w``'s, as GSPMD
    lays out JAX's head: ``x`` is made whole on those mesh dims (left batch-
    or feature-split there, DTensor contracts over ``D`` and hands every
    rank a partial sum of the whole vocabulary's logits), and ``w``'s other
    dim (``FSDP_RULES``' ``data`` cut) is gathered, as an FSDP weight is.
    On plain tensors both as they are."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return x, w
    from torch.distributed.tensor import Replicate

    x = reduce_partial(x)
    vocab = [i for i, p in enumerate(w.placements) if p.is_shard() and p.dim == vocab_dim]
    pl = [Replicate() if i in vocab or (p.is_shard() and p.dim == x.ndim - 1) else p
          for i, p in enumerate(x.placements)]
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return x, replicate_axis(w, 1 - vocab_dim)


def attention_on_shards(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v)`` (``q [B, Sq, H, dh]``, ``k`` / ``v [B, Skv, G, d]``,
    output ``[B, Sq, H, dv]``) on each rank's batch rows and heads.  The
    batch shards of ``q`` are kept; so is its head shard over a mesh dim of
    n ranks when H divides by n: with G too, each rank holds whole KV groups
    and their query heads; with n a multiple of G (fewer KV groups than
    ranks: GQA under wide TP), each rank takes its H / n query heads and the
    one KV group they read from the gathered K / V.  Anything else is
    gathered.  The output is placed as ``q`` was cut."""
    first = q if is_dtensor(q) else k if is_dtensor(k) else v if is_dtensor(v) else None
    if first is None:
        return fn(q, k, v)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = first.device_mesh
    h, g = q.shape[2], k.shape[2]
    q_pl, kv_pl, pick = [], [], None
    for i, p in enumerate(first.placements):
        n = mesh.size(i)
        if p.is_shard() and p.dim == 0:
            q_pl.append(Shard(0))
            kv_pl.append(Shard(0))
        elif p.is_shard() and p.dim == 2 and Shard(2) not in q_pl and h % n == 0 and (
                g % n == 0 or n % g == 0):
            q_pl.append(Shard(2))
            kv_pl.append(Shard(2) if g % n == 0 else Replicate())
            pick = None if g % n == 0 else i
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())

    def placed(t, pl, grad_pl=None):
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return t.redistribute(mesh, pl).to_local(grad_placements=grad_pl)

    ql = placed(q, q_pl)
    if pick is None:
        kl, vl = placed(k, kv_pl), placed(v, kv_pl)
    else:  # this rank's heads read one KV group; its gradient is this rank's share
        grad_pl = [Partial() if i == pick else p for i, p in enumerate(kv_pl)]
        grp = mesh.get_local_rank(pick) * (h // mesh.size(pick)) // (h // g)
        kl = placed(k, kv_pl, grad_pl)[:, :, grp:grp + 1]
        vl = placed(v, kv_pl, grad_pl)[:, :, grp:grp + 1]
    return DTensor.from_local(fn(ql, kl, vl), mesh, q_pl)


def _as_dtensor(t: torch.Tensor, mesh) -> torch.Tensor:
    """A plain tensor as a DTensor replicated on ``mesh``; a DTensor's
    pending reductions carried out."""
    from torch.distributed.tensor import DTensor, Replicate

    if is_dtensor(t):
        return reduce_partial(t)
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _placed(local: torch.Tensor, mesh, placements, shape) -> torch.Tensor:
    """``local`` as a DTensor of global ``shape`` (contiguous); the shards
    may be uneven (``torch.chunk``'s)."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, placements, shape=shape,
                              stride=_contiguous_stride(shape))


def _on_cut(fn, x: torch.Tensor, weights, x_dim: int, w_dim: int, by_x: bool):
    """``fn(x, weights)`` on each rank's batch rows of ``x`` and its part of
    a dim that ``x`` (dim ``x_dim``) and every weight (dim ``w_dim``) share:
    a mesh dim that cuts the rows of ``x`` gathers the weights (each rank's
    gradient its rows' share, summed back over the rows' ranks); one that
    cuts the shared dim -- of ``x`` when ``by_x``, else of the weights --
    keeps that cut on both; any other shard is gathered for the call.  The
    output (``x``'s leading dims up to ``x_dim``) is placed as ``x`` was
    cut.  Without a DTensor, the plain call."""
    ws = leaves(weights)
    first = next((t for t in [x, *ws] if is_dtensor(t)), None)
    if first is None:
        return fn(x, weights)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = first.device_mesh
    x = _as_dtensor(x, mesh)
    w0 = next((w for w in ws if is_dtensor(w)), None)
    x_pl, w_pl, grad_pl = [], [], []
    for i, xp in enumerate(x.placements):
        cut = xp if by_x else (w0.placements[i] if w0 is not None else Replicate())
        if xp.is_shard() and xp.dim == 0:
            x_pl.append(Shard(0))
            w_pl.append(Replicate())
            grad_pl.append(Partial())
        elif cut.is_shard() and cut.dim == (x_dim if by_x else w_dim):
            x_pl.append(Shard(x_dim))
            w_pl.append(Shard(w_dim))
            grad_pl.append(Shard(w_dim))
        else:
            x_pl.append(Replicate())
            w_pl.append(Replicate())
            grad_pl.append(Replicate())
    local = lambda w: _as_dtensor(w, mesh).redistribute(mesh, w_pl).to_local(  # noqa: E731
        grad_placements=grad_pl)
    out = fn(x.redistribute(mesh, x_pl).to_local(), tree_map(local, weights))
    return _placed(out, mesh, x_pl, (*x.shape[:x_dim + 1], *out.shape[x_dim + 1:]))


def on_experts(fn, x: torch.Tensor, experts):
    """``fn(x, experts)`` for a MoE expert block: ``x [B, E, C, D]`` (each
    expert's token slots), ``experts`` a tree of ``[E, ...]`` stacks, the
    output ``[B, E, ...]``.  On a mesh each rank runs ``fn`` on its batch
    rows and its experts, as GSPMD runs an FSDP weight: the stacks' expert
    cut is kept (``x`` takes the matching experts), any other cut of the
    stacks (``FSDP_RULES``' ``data`` cut of their rows) is gathered for the
    call and the gradient reduce-scattered back (``_on_cut``)."""
    return _on_cut(fn, x, experts, 1, 0, by_x=False)


def on_heads(fn, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``fn(x, w)`` for ``x [B, S, H, d]`` and a weight ``w [r, H * d']``
    whose last dim holds the heads in order (MLA's ``w_uk`` / ``w_uv``),
    the output ``[B, S, H, d'']``.  On a mesh each rank runs ``fn`` on its
    batch rows and, where ``x`` is cut over its heads, its heads of ``x``
    and of ``w``; any other cut of ``w`` is gathered (``_on_cut``)."""
    return _on_cut(fn, x, w, 2, 1, by_x=True)


class MixerCut:
    """This rank's share of a mixer that :func:`on_mixer` runs
    tensor-parallel: ``n`` ranks cut its heads or channels over one mesh
    dim, this one is rank ``r`` of them.  On tensors whose dim 0 holds the
    batch rows, ``gather(t, total)`` joins every rank's chunk of ``t``'s
    last dim (``total`` wide in all; the gradient is reduce-scattered back)
    and ``sum(t)`` adds ``t`` over the ranks (the gradient comes whole to
    each).  :data:`WHOLE`, the cut of a plain call, is one rank: both
    return ``t`` itself."""

    def __init__(self, mesh=None, dim: Optional[int] = None, rows_pl=None, rows: int = 0):
        self.mesh, self.dim, self.rows_pl, self.rows = mesh, dim, rows_pl, rows
        self.n = 1 if dim is None else mesh.size(dim)
        self.r = 0 if dim is None else mesh.get_local_rank(dim)

    def split(self, total: int, what: str) -> Tuple[int, int]:
        """``(first, count)`` of this rank's even share of ``total`` heads
        or channels; raises when the ranks do not divide them (a mixer is
        never gathered whole for want of a cut)."""
        if total % self.n:
            names = self.mesh.mesh_dim_names
            raise ValueError(
                f"{what} do not divide over the {self.n} ranks of mesh dim "
                f"{names[self.dim]!r} of the mesh {dict(zip(names, self.mesh.shape))}")
        k = total // self.n
        return self.r * k, k

    def chunk(self, total: int) -> Tuple[int, int]:
        """``[lo, hi)``: this rank's ``torch.chunk`` piece of ``total`` (a
        decode cache's cut, which need not be even)."""
        return self._span(self.r, total)

    def _on(self, p) -> list:
        """The rows' placements with ``p`` over the cut's mesh dim."""
        return [p if i == self.dim else q for i, q in enumerate(self.rows_pl)]

    def gather(self, t: torch.Tensor, total: int) -> torch.Tensor:
        if self.n == 1:
            return t
        from torch.distributed.tensor import Partial, Replicate, Shard

        d = _placed(t, self.mesh, self._on(Shard(t.ndim - 1)), (self.rows, *t.shape[1:-1], total))
        return d.redistribute(self.mesh, self._on(Replicate())).to_local(
            grad_placements=self._on(Partial()))

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.n == 1:
            return t
        return _SumOver.apply(t, (self.mesh, self.dim))

    def columns(self, w: torch.Tensor, total: int, keep) -> torch.Tensor:
        """The columns ``keep(r)`` (ascending) of a weight cut by columns
        over the ranks (``w``, ``[..., k]``: this rank's ``torch.chunk``
        piece of ``total``), for this rank ``r``, through one all-to-all in
        which each rank sends every rank the columns it holds of that
        rank's ``keep``; the gradient goes back the same way and is summed
        where several ranks took one column."""
        from torch.distributed import _functional_collectives as funcol

        spans = [self._span(k, total) for k in range(self.n)]
        lo, hi = spans[self.r]
        send, out_splits = [], []
        for m in range(self.n):
            send += [c - lo for c in keep(m) if lo <= c < hi]
        for k_lo, k_hi in spans:
            out_splits.append(sum(k_lo <= c < k_hi for c in keep(self.r)))
        in_splits = [sum(lo <= c < hi for c in keep(m)) for m in range(self.n)]
        idx = torch.tensor(send, dtype=torch.long, device=w.device)
        rows = w.index_select(-1, idx).movedim(-1, 0).contiguous()
        got = funcol.all_to_all_single_autograd(rows, out_splits, in_splits,
                                                (self.mesh, self.dim))
        if isinstance(got, funcol.AsyncCollectiveTensor):
            got = got.wait()
        return got.movedim(0, -1)

    def _span(self, r: int, total: int) -> Tuple[int, int]:
        per = -(-total // self.n)
        lo = min(r * per, total)
        return lo, min(lo + per, total)


class _SumOver(torch.autograd.Function):
    """``t`` summed over a mesh dim's ranks, whose uses of the sum differ
    (each rank normalizes its own channels by it): the gradient is summed
    over the ranks too."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol

    out = funcol.all_reduce(t, "sum", group)  # functional: the dry run counts it
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) else out


#: the cut of a plain call: one rank, every head and channel
WHOLE = MixerCut()


def on_mixer(fn, x: torch.Tensor, params, cache=None, *, cols=(), rows=(), cache_dims=None,
             state=None):
    """``fn(params, x, cut)`` -- or ``fn(params, x, cache, cut)``, which
    returns ``(out, cache)``, or with ``state`` (and no ``cache``)
    ``fn(params, x, cut)`` returning ``(out, cache)``, a prefill's whose
    leaves have the global shapes of ``state``'s (a template: meta tensors
    will do) -- for a
    recurrent mixer whose ``params[k]["w"]``
    is cut by columns for ``k`` in ``cols`` (the input projections, ``[D,
    F]``) and by rows for ``k`` in ``rows`` (the output projection, ``[F,
    D]``), every other param replicated; ``x [B, ...]`` is batch-leading,
    and ``cache`` a dict of batch-leading tensors, leaf ``k`` cut over its
    dim ``cache_dims[k]``.

    On a mesh each rank runs ``fn`` on its batch rows and, over the mesh dim
    that cuts ``params[cols[0]]`` by columns, on its share of the mixer's
    heads or channels (``cut``, a :class:`MixerCut`): the column and row
    cuts are kept, the replicated params are whole (``fn`` slices its
    share), and ``fn``'s output is a partial sum over the cut, reduced into
    ``x``'s placements.  A mesh dim that cuts the rows of ``x`` gathers the
    params' cut there (``FSDP_RULES``' ``data`` cut; each rank's gradient is
    its rows' share, reduce-scattered back), as ``_on_cut`` does; any other
    cut of ``x`` is gathered.  The cache comes to ``fn`` cut over the rows
    and, over the mixer's cut, as ``cache_dims`` says (where it was placed
    so, as the JAX package's ``_cache_pspecs`` places it, nothing moves),
    and comes back in the placements it was given.  A prefill's cache
    (``state``) comes back in those placements:
    over the rows and, on the mixer's cut, over ``cache_dims[k]``, where the
    decode steps take it.  Without a DTensor, ``fn(..., WHOLE)``: the plain
    call."""
    first = next((t for t in [x, *leaves(params), *leaves(cache or {})] if is_dtensor(t)), None)
    if first is None:
        return fn(params, x, WHOLE) if cache is None else fn(params, x, cache, WHOLE)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = first.device_mesh
    x = _as_dtensor(x, mesh)
    col = params[cols[0]]["w"] if cols else None
    tp = None
    row_dims = [i for i, p in enumerate(x.placements) if p.is_shard() and p.dim == 0]
    if is_dtensor(col):
        tp = next((i for i, p in enumerate(col.placements)
                   if i not in row_dims and p.is_shard() and p.dim == col.ndim - 1), None)
    rows_pl = [Shard(0) if i in row_dims else Replicate() for i in range(mesh.ndim)]
    x_grad = [Partial() if i == tp else p for i, p in enumerate(rows_pl)]

    def weight(path, w):
        key = path.split("]")[0].strip("['") if path.endswith("['w']") else None
        own = Shard(w.ndim - 1) if key in cols else Shard(0) if key in rows else Replicate()
        pl = [own if i == tp else Replicate() for i in range(mesh.ndim)]
        # each rank's gradient: its rows' share, and of a replicated param
        # its own heads' or channels' share
        grad = [Partial() if i in row_dims or (i == tp and not own.is_shard()) else p
                for i, p in enumerate(pl)]
        return _as_dtensor(w, mesh).redistribute(mesh, pl).to_local(grad_placements=grad)

    cut = MixerCut(mesh, tp, rows_pl, x.shape[0])
    p_local = map_with_path(weight, params)
    x_local = x.redistribute(mesh, rows_pl).to_local(grad_placements=x_grad)
    partial = [Partial() if i == tp else p for i, p in enumerate(rows_pl)]

    def reduced(out):
        return _placed(out, mesh, partial, (x.shape[0], *out.shape[1:])).redistribute(
            mesh, x.placements)

    c_pl = {k: [Shard(cache_dims[k]) if i == tp else p for i, p in enumerate(rows_pl)]
            for k in (cache if cache is not None else state or {})}
    if cache is None:
        if state is None:
            return reduced(fn(p_local, x_local, cut))
        out, new = fn(p_local, x_local, cut)
        return reduced(out), {k: _placed(new[k], mesh, c_pl[k], state[k].shape) for k in new}
    c_local = {k: _as_dtensor(t, mesh).redistribute(mesh, c_pl[k]).to_local()
               for k, t in cache.items()}
    out, new = fn(p_local, x_local, c_local, cut)
    placed = {}
    for k, t in cache.items():
        placed[k] = _placed(new[k], mesh, c_pl[k], t.shape)
        if is_dtensor(t) and list(t.placements) != c_pl[k]:
            placed[k] = placed[k].redistribute(mesh, t.placements)
    return reduced(out), placed


def on_cache(fn, rows, cache):
    """One decode step's attention over a KV cache kept where it lies:
    ``fn(rows, cache, lo, partial)``, where ``rows`` are batch-leading
    tensors (the queries, the new token's entries, ``pos``), ``cache`` a
    dict of ``[B, S, ...]`` tensors of one placement and ``lo`` the first
    sequence slot of the ``cache`` that ``fn`` is handed.  ``fn`` writes the
    new token into its slots that hold it and returns ``(out, cache)`` --
    ``out [B, 1, H, d]`` normalized over its slots, in f32 -- or, with
    ``partial``, ``(out, m, l, cache)``, ``m`` / ``l [B, 1, H]`` the max and
    the sum of ``exp(logit - m)`` over its slots.

    On a mesh each rank runs ``fn`` on its batch rows of the rows and its
    rows and sequence slots of the cache (flash-decoding's split-K, as the
    JAX package's ``_cache_pspecs`` lays a decode cache out: batch over the
    data axes, sequence over ``model``); a mesh dim that cuts the sequence
    combines the ranks' partial outputs with a log-sum-exp all-reduce, so
    no rank gathers the cache.  A shard of any other cache dim is gathered
    for the call and cut back.  Returns ``(out, cache)``: ``out`` placed as
    the batch rows, every cache tensor in the placements it came in.  With
    one slice (no DTensor, or no sequence cut over more than one rank)
    ``out`` is ``fn``'s own, bit for bit."""
    first = next((t for t in cache.values() if is_dtensor(t)), None)
    if first is None:
        return fn(rows, cache, 0, False)
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard

    mesh, given = first.device_mesh, first.placements
    split = next((i for i, p in enumerate(given) if p.is_shard() and p.dim == 1), None)
    c_pl = [p if p.is_shard() and (p.dim == 0 or i == split) else Replicate()
            for i, p in enumerate(given)]
    r_pl = [Shard(0) if p.is_shard() and p.dim == 0 else Replicate() for p in given]
    local_rows = tree_map(lambda t: _as_dtensor(t, mesh).redistribute(mesh, r_pl).to_local()
                          if isinstance(t, torch.Tensor) else t, rows)
    local = {k: t.redistribute(mesh, c_pl).to_local() for k, t in cache.items()}
    lo = 0
    if split is not None:
        per = -(-first.shape[1] // mesh.size(split))  # torch.chunk's slots a shard
        lo = min(mesh.get_local_rank(split) * per, first.shape[1])
    if split is None or mesh.size(split) == 1:
        out, new = fn(local_rows, local, lo, False)
    else:
        out, m, l, new = fn(local_rows, local, lo, True)
        group = (mesh, split)  # functional collectives: the dry run counts them
        c = l * torch.exp(m - funcol.all_reduce(m, "max", group))
        out = funcol.all_reduce(out * (c / funcol.all_reduce(c, "sum", group))[..., None],
                                "sum", group)
        if isinstance(out, funcol.AsyncCollectiveTensor):
            out = out.wait()
    b = rows[0].shape[0]
    out = _placed(out, mesh, r_pl, (b, *out.shape[1:]))
    return out, {k: _placed(new[k], mesh, c_pl, t.shape).redistribute(mesh, given)
                 for k, t in cache.items()}


def on_sequence(fn, t: torch.Tensor, size: int) -> torch.Tensor:
    """``fn(t)``, which maps a layer's prompt entries ``t [B, S, ...]`` to
    the ``size`` slots of its cache ``[B, size, ...]`` (padded, or a ring's
    slots picked), on each rank's shard of ``t`` with its sequence whole:
    each rank fills the slots of its rows and heads, and the cache keeps
    ``t``'s placements (:func:`place_cache` then cuts its slots).  On a
    plain tensor the plain call."""
    if not is_dtensor(t):
        return fn(t)
    t = replicate_axis(reduce_partial(t), 1)
    return _placed(fn(t.to_local()), t.device_mesh, t.placements,
                   (t.shape[0], size, *t.shape[2:]))


def placed_like(tree, like):
    """Each DTensor of ``tree`` redistributed to the placements of its
    counterpart in ``like`` (MLA's absorbed context onto the query's
    heads); plain tensors as they are."""
    return tree_map(lambda t, ref: t.redistribute(ref.device_mesh, ref.placements)
                    if is_dtensor(t) and is_dtensor(ref) else t, tree, like)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _local_view(x, new_shape, local_shape, placements):
    from torch.distributed.tensor import DTensor

    shape = torch.Size(new_shape)
    return DTensor.from_local(x.to_local().reshape(local_shape), x.device_mesh, placements,
                              shape=shape, stride=_contiguous_stride(shape))


def split_last(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """``x.reshape(*x.shape[:-1], n, d)`` (``[..., n * d]`` -> heads).  On a
    DTensor a shard of the last dim becomes a shard of the ``n`` heads when
    ``n`` divides by its mesh dim, else the last dim is gathered first."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-1], n, d)
    x = reduce_partial(x)
    last = x.ndim - 1
    cut = [i for i, p in enumerate(x.placements) if p.is_shard() and p.dim == last]
    if len(cut) > 1 or (cut and n % x.device_mesh.size(cut[0])):
        x, cut = replicate_axis(x, -1), []
    k = x.device_mesh.size(cut[0]) if cut else 1
    local = x.to_local().shape
    return _local_view(x, (*x.shape[:-1], n, d), (*local[:-1], n // k, d), x.placements)


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """``x.reshape(*x.shape[:-2], -1)`` (heads -> ``[..., n * d]``).  On a
    DTensor a shard of the heads dim becomes a shard of the merged dim; a
    shard of the last dim is gathered first."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-2], -1)
    x = replicate_axis(reduce_partial(x), -1)
    local = x.to_local().shape
    return _local_view(x, (*x.shape[:-2], x.shape[-2] * x.shape[-1]),
                       (*local[:-2], local[-2] * local[-1]), x.placements)


def _shard_like(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The plain tensor ``t`` -- whole, the same on every rank -- as a
    DTensor of ``placements`` on ``mesh``: each rank keeps its own chunk
    (``torch.chunk`` over each mesh dim in turn, DTensor's layout), with no
    collective.  A ``Partial`` placement becomes ``Replicate``."""
    from torch.distributed.tensor import DTensor, Replicate

    pl = [Replicate() if p.is_partial() else p for p in placements]
    local = t
    for i, p in enumerate(pl):
        if p.is_shard():
            n, r = mesh.size(i), mesh.get_local_rank(i)
            chunks = torch.chunk(local, n, dim=p.dim)
            local = chunks[r] if r < len(chunks) else local.narrow(p.dim, 0, 0)
    return DTensor.from_local(local.contiguous(), mesh, pl, shape=t.shape,
                              stride=_contiguous_stride(t.shape))


def on_whole(fn, x: torch.Tensor):
    """``fn(x)`` on the whole of ``x``: a DTensor ``x`` is gathered to
    every rank, ``fn`` runs on the plain tensor, and each tensor it returns
    (of ``x``'s rank) is cut back to ``x``'s placements (``_shard_like``).
    For work whose result must equal the plain op's bit for bit where a
    per-shard version would not: a projection's global top-k and its ties,
    the micro-batch rows of a batch.  Costs one gather of ``x`` and one
    whole result on each rank.  Without a DTensor, the plain call."""
    if not is_dtensor(x):
        return fn(x)
    mesh, pl = x.device_mesh, x.placements
    out = fn(x.full_tensor())
    return tree_map(lambda t: _shard_like(t, mesh, pl) if isinstance(t, torch.Tensor) else t, out)
