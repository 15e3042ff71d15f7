"""Compiler core of the port: graph IR + passes + plans, pruning, formats."""

from . import graph, pruning, sparse

__all__ = ["graph", "pruning", "sparse"]
