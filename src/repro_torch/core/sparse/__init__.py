"""Compact sparse weight formats and the matrix reorder (port)."""

from .formats import PBCSR, ChannelCompact, ColumnCompact, dense_nbytes
from .packing import block_mask
from .reorder import Band, ReorderPlan, balance_stats, plan_reorder

__all__ = [
    "PBCSR",
    "Band",
    "ChannelCompact",
    "ColumnCompact",
    "ReorderPlan",
    "balance_stats",
    "block_mask",
    "dense_nbytes",
    "plan_reorder",
]
