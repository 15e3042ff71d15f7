"""Stdlib helpers of the port (its own copies: the port imports nothing of
the JAX package)."""
