"""Compiler core of the port: graph IR + passes + plans, pruning, formats."""
