"""Compact sparse weight formats (port)."""

from .formats import ChannelCompact, ColumnCompact

__all__ = ["ChannelCompact", "ColumnCompact"]
