"""Model graphs of the port (the paper's three demo CNN apps)."""

from . import cnn

__all__ = ["cnn"]
