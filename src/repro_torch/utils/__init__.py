"""Stdlib helpers of the port (its own copies: the port imports nothing of
the JAX package).  The JAX package's HLO parsers (``collective_bytes``,
``op_histogram``) have no counterpart: ``utils.op_costs`` counts the eager
ops and collectives instead."""

from .fileio import atomic_write_json, atomic_write_text
from .flops import model_flops, param_counts
from .retry import retry_call

__all__ = ["atomic_write_json", "atomic_write_text", "model_flops", "param_counts",
           "retry_call"]
