"""Block-table paged KV-cache for autoregressive serving (a copy of
``repro.serving.kvcache``: numpy only).

The vLLM/pie-style memory layout: the cache is a fixed pool of fixed-size
pages (``[num_pages, n_layers, page_size, n_kv_heads, head_dim]`` for each
of k and v), and every live sequence owns an ordered *block table* of page
ids.  Appending tokens fills the tail page and pulls fresh pages from a
LIFO freelist; releasing a finished sequence returns its pages -- no
compaction, no per-sequence max-length reservation, so B sequences of
wildly different lengths share the pool densely.

The executor side stays dense: :meth:`gather` materializes each sequence's
pages as one contiguous ``[B, L, S_pad, G, dh]`` span (token axis = the
block table walked in order, zero-filled past each sequence's capacity) and
the ``attention`` op masks with ``lengths`` -- slots past the live length
never attract probability mass, so gather-then-mask equals contiguous-cache
attention exactly.

Pools are host numpy on purpose (as in the JAX package): appends are
in-place writes, and the gather ships exactly the pages the batch needs to
the device each tick.  A device-resident pool is later work.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["CacheFullError", "PagedKVCache"]


class CacheFullError(RuntimeError):
    """The freelist cannot cover a requested allocation."""


class PagedKVCache:
    """Fixed-pool paged KV storage with per-sequence block tables.

    Thread-safe: the serving loop appends/gathers while submit/health
    threads read occupancy.
    """

    def __init__(
        self,
        *,
        num_pages: int,
        page_size: int,
        n_layers: int,
        n_kv_heads: int,
        head_dim: int,
        dtype=np.float32,
    ):
        if num_pages < 1 or page_size < 1:
            raise ValueError("num_pages and page_size must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.n_layers = int(n_layers)
        self.n_kv_heads = int(n_kv_heads)
        self.head_dim = int(head_dim)
        shape = (num_pages, n_layers, page_size, n_kv_heads, head_dim)
        self.k_pool = np.zeros(shape, dtype)
        self.v_pool = np.zeros(shape, dtype)
        #: LIFO freelist: released pages are reused hottest-first
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._tables: Dict[int, List[int]] = {}
        self._lengths: Dict[int, int] = {}
        self._lock = threading.Lock()
        self.stats = {"allocs": 0, "releases": 0, "peak_used": 0}

    # -- occupancy ----------------------------------------------------------- #
    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self) -> int:
        with self._lock:
            return self.num_pages - len(self._free)

    def sequences(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(self._tables)

    def length(self, seq_id: int) -> int:
        with self._lock:
            return self._lengths[seq_id]

    def capacity(self, seq_id: int) -> int:
        with self._lock:
            return len(self._tables[seq_id]) * self.page_size

    def block_table(self, seq_id: int) -> Tuple[int, ...]:
        with self._lock:
            return tuple(self._tables[seq_id])

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    # -- lifecycle ----------------------------------------------------------- #
    def allocate(self, seq_id: int) -> None:
        """Register an empty sequence (no pages yet)."""
        with self._lock:
            if seq_id in self._tables:
                raise ValueError(f"sequence {seq_id} already allocated")
            self._tables[seq_id] = []
            self._lengths[seq_id] = 0

    def ensure_capacity(self, seq_id: int, n_tokens: int) -> None:
        """Grow ``seq_id``'s block table to hold ``n_tokens``.  All-or-
        nothing: a :class:`CacheFullError` leaves the table unchanged."""
        with self._lock:
            table = self._tables[seq_id]
            need = self.pages_for(n_tokens) - len(table)
            if need <= 0:
                return
            if need > len(self._free):
                raise CacheFullError(
                    f"need {need} pages for seq {seq_id}, "
                    f"{len(self._free)} free of {self.num_pages}"
                )
            for _ in range(need):
                table.append(self._free.pop())
            self.stats["allocs"] += need
            used = self.num_pages - len(self._free)
            self.stats["peak_used"] = max(self.stats["peak_used"], used)

    def append(self, seq_id: int, k_new: np.ndarray, v_new: np.ndarray) -> None:
        """Append ``T`` tokens of per-layer KV (``[T, L, G, dh]`` each),
        allocating pages on demand."""
        k_new = np.asarray(k_new)
        v_new = np.asarray(v_new)
        t = k_new.shape[0]
        if k_new.shape != v_new.shape or k_new.shape[1:] != (
            self.n_layers, self.n_kv_heads, self.head_dim
        ):
            raise ValueError(
                f"expected [T, {self.n_layers}, {self.n_kv_heads}, "
                f"{self.head_dim}], got k {k_new.shape} v {v_new.shape}"
            )
        self.ensure_capacity(seq_id, self.length(seq_id) + t)
        with self._lock:
            table = self._tables[seq_id]
            pos = self._lengths[seq_id]
            ps = self.page_size
            written = 0
            while written < t:
                page = table[(pos + written) // ps]
                slot = (pos + written) % ps
                run = min(t - written, ps - slot)
                src = slice(written, written + run)
                # pool layout is [page, L, slot, G, dh]; the new tokens come
                # in token-major [T, L, G, dh] -> swap to [L, T, G, dh]
                self.k_pool[page, :, slot : slot + run] = k_new[src].swapaxes(0, 1)
                self.v_pool[page, :, slot : slot + run] = v_new[src].swapaxes(0, 1)
                written += run
            self._lengths[seq_id] = pos + t

    def release(self, seq_id: int) -> int:
        """Return a finished sequence's pages to the freelist."""
        with self._lock:
            pages = self._tables.pop(seq_id)
            del self._lengths[seq_id]
            self._free.extend(reversed(pages))
            self.stats["releases"] += len(pages)
            return len(pages)

    # -- executor-facing gather ---------------------------------------------- #
    def gather(
        self,
        seq_ids: Sequence[int],
        *,
        min_tokens: int = 0,
        pad_to: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Materialize the batch's cache spans: ``(k_ctx, v_ctx, lengths)``
        with k/v ``[B, L, S_pad, G, dh]`` and lengths ``[B] int32``.

        ``S_pad`` is the largest per-sequence capacity (every owned page),
        raised to at least ``min_tokens`` rounded up to a page multiple --
        the decode step needs ``length + 1`` slots for the incoming token.
        """
        ps = self.page_size
        with self._lock:
            tables = [list(self._tables[s]) for s in seq_ids]
            lengths = np.array(
                [self._lengths[s] for s in seq_ids], np.int32
            )
        span = max(
            [len(tb) * ps for tb in tables] + [self.pages_for(min_tokens) * ps]
        )
        if pad_to is not None:
            span = max(span, pad_to)
            if span % ps:
                raise ValueError(f"pad_to {pad_to} not a page multiple")
        b = len(seq_ids)
        shape = (b, self.n_layers, span, self.n_kv_heads, self.head_dim)
        k_ctx = np.zeros(shape, self.k_pool.dtype)
        v_ctx = np.zeros(shape, self.v_pool.dtype)
        for j, tb in enumerate(tables):
            if not tb:
                continue
            n = len(tb) * ps
            # [n_pages, L, ps, G, dh] -> [L, n_pages*ps, G, dh]
            k_ctx[j, :, :n] = self.k_pool[tb].swapaxes(0, 1).reshape(
                self.n_layers, n, self.n_kv_heads, self.head_dim
            )
            v_ctx[j, :, :n] = self.v_pool[tb].swapaxes(0, 1).reshape(
                self.n_layers, n, self.n_kv_heads, self.head_dim
            )
        return k_ctx, v_ctx, lengths

    # -- invariants (the property-test surface) ------------------------------ #
    def check_invariants(self) -> None:
        """Every page is either free or owned by exactly one sequence, and
        every table covers its sequence's length."""
        with self._lock:
            owned: List[int] = []
            for sid, tb in self._tables.items():
                owned.extend(tb)
                if len(tb) * self.page_size < self._lengths[sid]:
                    raise AssertionError(
                        f"seq {sid}: length {self._lengths[sid]} exceeds "
                        f"capacity {len(tb) * self.page_size}"
                    )
            if len(set(owned)) != len(owned):
                raise AssertionError("page double-assigned across sequences")
            all_pages = set(owned) | set(self._free)
            if len(self._free) != len(set(self._free)):
                raise AssertionError("freelist contains duplicates")
            if all_pages != set(range(self.num_pages)) or len(owned) + len(
                self._free
            ) != self.num_pages:
                raise AssertionError("page leak: owned + free != pool")

    def occupancy(self) -> Dict[str, int]:
        with self._lock:
            return {
                "num_pages": self.num_pages,
                "page_size": self.page_size,
                "free_pages": len(self._free),
                "used_pages": self.num_pages - len(self._free),
                "sequences": len(self._tables),
                **self.stats,
            }
