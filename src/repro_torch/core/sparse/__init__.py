"""Compact sparse weight formats, their layout helpers and the matrix
reorder (port)."""

from .formats import CSR, PBCSR, ChannelCompact, ColumnCompact, dense_nbytes
from .packing import (
    block_mask,
    extract_blocks,
    pack_balanced,
    pad_to_multiple,
    unpack_balanced,
)
from .reorder import (
    Band,
    ReorderPlan,
    apply_column_perm,
    balance_stats,
    fold_perm_into_next,
    invert_column_perm,
    plan_reorder,
)

__all__ = [
    "CSR",
    "PBCSR",
    "Band",
    "ChannelCompact",
    "ColumnCompact",
    "ReorderPlan",
    "apply_column_perm",
    "balance_stats",
    "block_mask",
    "dense_nbytes",
    "extract_blocks",
    "fold_perm_into_next",
    "invert_column_perm",
    "pack_balanced",
    "pad_to_multiple",
    "plan_reorder",
    "unpack_balanced",
]
