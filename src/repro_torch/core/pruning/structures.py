"""Structured-sparsity set definitions (the ``S_i`` of the paper's Eq. 1).

A copy of ``repro.core.pruning.structures`` (plain dataclasses, no array
code).  The port projects onto Column, Channel and PatternKernel so far
(``projections.py``); the other sets are declared for the compiler layer and
their projections raise ``NotImplementedError`` until a later slice.

Each structure describes *what unit is pruned as a whole* for a 2-D weight
matrix ``W[K, N]`` (input-features x output-features; convolutions are viewed
through im2col as ``[C_in*kh*kw, C_out]``) and knows how to

* ``group_shape`` -- the granularity at which magnitude statistics are pooled,
* ``project``     -- (in projections.py) the Euclidean projection onto the set,
* describe itself for the compiler layer (storage format + reorder legality).

The paper's taxonomy maps as:

==================  =============================================
paper term          structure here
==================  =============================================
filter pruning      ``Row``     (prunes W rows / conv filters)
channel pruning     ``Channel`` (prunes W cols / conv in-channels)
column pruning      ``Column``  (same position in every filter)
pattern pruning     ``PatternKernel`` (per 3x3 kernel patterns)
connectivity        ``PatternKernel(connectivity=...)``
(TPU adaptation)    ``Block``   (MXU-tile aligned bm x bn blocks)
(TPU adaptation)    ``NM``      (N:M within fixed groups)
==================  =============================================

``Block`` is the TPU-native prune unit of the JAX package: a pruned block is
skipped entirely by its BSR kernel, so the surviving compute still runs as
dense matrix-unit tiles (the port's block-sparse path is a later slice).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = [
    "Structure",
    "Unstructured",
    "Row",
    "Column",
    "Channel",
    "Block",
    "NM",
    "PatternKernel",
    "BankBalanced",
    "CANONICAL_PATTERNS",
]


@dataclasses.dataclass(frozen=True)
class Structure:
    """Base class for a structured-sparsity set."""

    #: fraction of prune-units removed (0.0 = dense, 0.9 = 90% pruned)
    sparsity: float = 0.5

    def validate(self, shape: Tuple[int, ...]) -> None:
        if not (0.0 <= self.sparsity < 1.0):
            raise ValueError(f"sparsity must be in [0,1), got {self.sparsity}")
        if len(shape) != 2:
            raise ValueError(f"{type(self).__name__} expects 2-D weights, got {shape}")

    # ------------------------------------------------------------------ #
    # Metadata consumed by the compiler layer (core/graph, core/sparse). #
    # ------------------------------------------------------------------ #
    @property
    def kind(self) -> str:
        return type(self).__name__.lower()

    @property
    def storage_format(self) -> str:
        """Preferred compact storage format for weights pruned with this set."""
        return "masked"  # fall-back: dense + mask

    @property
    def reorderable(self) -> bool:
        """Whether matrix-reorder (row permutation) can balance this structure."""
        return False

    def n_kept(self, n_units: int) -> int:
        """Number of prune-units kept for a given unit count (at least one)."""
        return max(1, int(round(n_units * (1.0 - self.sparsity))))


@dataclasses.dataclass(frozen=True)
class Unstructured(Structure):
    """Element-wise magnitude pruning (baseline the paper argues *against*)."""

    @property
    def storage_format(self) -> str:
        return "csr"


@dataclasses.dataclass(frozen=True)
class Row(Structure):
    """Filter pruning: removes entire rows of W (output features / filters)."""

    @property
    def storage_format(self) -> str:
        return "rowcompact"

    @property
    def reorderable(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class Column(Structure):
    """Column pruning (paper: style transfer): removes the same input position
    from every filter, i.e. entire rows of the im2col'd ``W[K, N]`` viewed from
    the K side.  Here we prune along axis 0 of ``W[K, N]`` -- the compacted
    weight is a strictly smaller dense GEMM plus a static input gather."""

    @property
    def storage_format(self) -> str:
        return "colcompact"

    @property
    def reorderable(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class Channel(Structure):
    """Channel pruning: removes output columns of ``W[K, N]`` *and* the
    corresponding input channel of the next layer (handled by the graph pass).

    Contract: a pruned channel is removed *entirely* -- its bias too.  The
    masked-dense reference of a channel-pruned layer is therefore
    ``act(x @ (W*mask) + b*col_mask)`` (see graph/passes.substitute_sparse)."""

    @property
    def storage_format(self) -> str:
        return "channelcompact"

    @property
    def reorderable(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class Block(Structure):
    """Matrix-unit-tile block pruning (the JAX package's TPU adaptation).

    ``W[K, N]`` is tiled into ``(bm, bn)`` blocks; whole blocks are pruned by
    pooled magnitude.  Surviving blocks execute as dense tiles through a BSR
    kernel.  ``bm``/``bn`` should be multiples of the hardware tile.
    """

    bm: int = 128
    bn: int = 128
    #: if set, force the same number of kept blocks per block-row
    #: (load-balance contract consumed by the BSR kernel; the matrix-reorder
    #: pass can establish this post-hoc for free-form block sparsity).
    balanced: bool = True

    def validate(self, shape: Tuple[int, ...]) -> None:
        super().validate(shape)
        k, n = shape
        if k % self.bm or n % self.bn:
            raise ValueError(
                f"Block({self.bm},{self.bn}) does not tile weight {shape}; "
                "pad the layer or choose divisor block dims"
            )

    @property
    def storage_format(self) -> str:
        return "pbcsr"

    @property
    def reorderable(self) -> bool:
        return True

    def grid(self, shape: Tuple[int, int]) -> Tuple[int, int]:
        return shape[0] // self.bm, shape[1] // self.bn


@dataclasses.dataclass(frozen=True)
class NM(Structure):
    """N:M sparsity: keep ``n_keep`` of every ``m`` consecutive weights along
    the input (K) axis.  ``sparsity`` is derived, not free."""

    n_keep: int = 2
    m: int = 4

    def __post_init__(self):
        object.__setattr__(self, "sparsity", 1.0 - self.n_keep / self.m)

    def validate(self, shape: Tuple[int, ...]) -> None:
        if len(shape) != 2:
            raise ValueError(f"NM expects 2-D weights, got {shape}")
        if shape[0] % self.m:
            raise ValueError(f"K={shape[0]} not divisible by m={self.m}")

    @property
    def storage_format(self) -> str:
        return "nmpacked"


#: The canonical 4-entry patterns inside a 3x3 kernel used by pattern pruning
#: (PCONV, Ma et al. 2019 -- the paper's own citation).  Each pattern keeps the
#: centre plus three of its 4-neighbours; these dominate trained CNNs and keep
#: the receptive field connected.
CANONICAL_PATTERNS: Tuple[Tuple[int, ...], ...] = (
    (1, 3, 4, 5),  # centre + W,E + N      (indices into the 3x3 raster 0..8)
    (1, 4, 5, 7),  # centre + N,S + E
    (3, 4, 5, 7),  # centre + W,E + S
    (1, 3, 4, 7),  # centre + N,S + W
    (0, 1, 3, 4),  # NW corner block
    (1, 2, 4, 5),  # NE corner block
    (3, 4, 6, 7),  # SW corner block
    (4, 5, 7, 8),  # SE corner block
)


@dataclasses.dataclass(frozen=True)
class PatternKernel(Structure):
    """Pattern + connectivity pruning for conv kernels (paper: coloring & SR).

    Operates on 4-D conv weights ``[C_out, C_in, kh, kw]`` flattened per-kernel:
    every (c_out, c_in) kernel is either (a) assigned the best-matching pattern
    from the pattern library (pattern pruning) or (b) removed entirely
    (connectivity pruning), with ``connectivity`` the fraction of kernels cut.
    """

    patterns: Tuple[Tuple[int, ...], ...] = CANONICAL_PATTERNS
    #: fraction of whole kernels removed on top of per-kernel patterns
    connectivity: float = 0.0
    kernel_size: int = 3

    def validate(self, shape: Tuple[int, ...]) -> None:  # 4-D here
        if len(shape) != 4:
            raise ValueError(f"PatternKernel expects 4-D conv weights, got {shape}")
        kh, kw = shape[2], shape[3]
        if kh != self.kernel_size or kw != self.kernel_size:
            raise ValueError(
                f"PatternKernel(kernel_size={self.kernel_size}) vs weight {shape}"
            )
        if not (0.0 <= self.connectivity < 1.0):
            raise ValueError(f"connectivity in [0,1), got {self.connectivity}")

    @property
    def storage_format(self) -> str:
        return "pattern"

    @property
    def reorderable(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class BankBalanced(Structure):
    """Bank-balanced sparsity: within every row, keep exactly ``n_kept`` of the
    elements of each contiguous bank of ``bank`` columns.  A middle ground
    between unstructured and column pruning; vector-unit friendly."""

    bank: int = 128

    def validate(self, shape: Tuple[int, ...]) -> None:
        super().validate(shape)
        if shape[1] % self.bank:
            raise ValueError(f"N={shape[1]} not divisible by bank={self.bank}")

    @property
    def storage_format(self) -> str:
        return "bankpacked"
