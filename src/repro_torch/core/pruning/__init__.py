"""Structured pruning (port): the structure sets and their projections."""

from .projections import mask_for, project, topk_mask
from .structures import (
    CANONICAL_PATTERNS,
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

__all__ = [
    "CANONICAL_PATTERNS",
    "NM",
    "BankBalanced",
    "Block",
    "Channel",
    "Column",
    "PatternKernel",
    "Row",
    "Structure",
    "Unstructured",
    "mask_for",
    "project",
    "topk_mask",
]
