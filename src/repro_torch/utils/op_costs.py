"""Per-device costs of an eager PyTorch step, counted op by op (the port's
counterpart of the JAX package's ``utils/hlo.py`` and XLA's cost analysis).

:class:`OpCosts` is a ``TorchDispatchMode`` that sees the aten ops each rank
runs on its *local* tensors: it lets DTensor ops through (DTensor then runs
the local ops, and the collectives its redistributions issue, beneath it)
and skips the global-shape ops DTensor's sharding propagation runs to infer
output metadata.  It counts, for one device:

* ``flops``: ``torch.utils.flop_counter``'s formulas (the ones
  ``FlopCounterMode`` uses) on the local shapes: matmuls, convolutions,
  attention;
* ``bytes_accessed``: every op's tensor inputs plus outputs on local shapes
  (views and allocations move nothing), which is what the eager port really
  moves -- no fusion;
* ``collectives``: operand bytes of every ``_c10d_functional`` collective,
  by kind (all-gather, reduce-scatter, all-reduce, all-to-all), as
  ``utils/hlo.collective_bytes`` counts them in the JAX package's HLO;
* ``peak_live_bytes``: the largest sum of live storages, the arguments
  registered with :meth:`OpCosts.track` included (storages are freed when
  their last tensor goes).

On meta-device DTensors of a fake process group (``launch/dryrun.py``)
nothing is allocated, so a full-size step of any mesh can be counted in one
process.
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["OpCosts", "COLLECTIVE_KINDS"]

#: ``_c10d_functional`` op -> the JAX package's collective kind
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}

#: ops that move no data (allocations; views are ``func.is_view``)
_NO_DATA = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided", "device",
            "lift_fresh"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCosts(TorchDispatchMode):
    """Counts the local ops run inside it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: Dict[str, int] = defaultdict(int)
        self.ops: Dict[str, int] = defaultdict(int)
        self.live = 0
        self.peak_live_bytes = 0
        self._storages: Dict[int, int] = {}
        #: nesting of DTensor's metadata propagation, whose ops run on
        #: global shapes and are not the device's
        self._propagating = 0
        self._patched = []

    # -- storages ----------------------------------------------------------- #

    def track(self, tensors: Iterable[torch.Tensor]) -> int:
        """Count these tensors' storages as live (a step's arguments);
        returns the bytes newly counted."""
        before = self.live
        for t in tensors:
            self._add(t)
        return self.live - before

    def _add(self, t: torch.Tensor) -> None:
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    # -- the mode ----------------------------------------------------------- #

    def __enter__(self):
        self._pause_propagation()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for cls, name, fn in self._patched:
                setattr(cls, name, fn)
            self._patched = []

    def _pause_propagation(self) -> None:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        costs = self
        for name in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta"):
            fn = ShardingPropagator.__dict__.get(name)
            if fn is None:
                continue

            def wrapped(*a, __fn=fn, **k):
                costs._propagating += 1
                try:
                    return __fn(*a, **k)
                finally:
                    costs._propagating -= 1

            setattr(ShardingPropagator, name, wrapped)
            self._patched.append((ShardingPropagator, name, fn))
        if not self._patched:
            raise RuntimeError("OpCosts: DTensor's metadata propagation was not found")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._propagating:
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._overloadpacket.__name__
        self.ops[f"{ns}.{name}"] += 1
        outs = _tensors(out)
        for t in outs:
            self._add(t)
        if ns == "_c10d_functional":
            kind = COLLECTIVE_KINDS.get(name)
            if kind is not None:
                self.collectives[kind] += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            return
        if ns not in ("aten", "prims"):
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if func.is_view or name in _NO_DATA:
            return
        self.bytes_accessed += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes_accessed += sum(_nbytes(t) for t in outs)

    def report(self) -> Dict[str, Any]:
        per_kind = {k: int(v) for k, v in sorted(self.collectives.items())}
        return {
            "flops": float(self.flops),
            "bytes_accessed": float(self.bytes_accessed),
            "collectives": {"total_bytes": int(sum(per_kind.values())), "per_kind": per_kind},
            "peak_live_bytes": int(self.peak_live_bytes),
        }
