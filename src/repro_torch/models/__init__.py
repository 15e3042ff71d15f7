"""Model graphs of the port: the paper's three demo CNN apps (``cnn``) and
the dense GQA decoder (``layers``, ``attention``, ``ffn``, ``transformer``,
and its plan lowering ``transformer_graph``)."""

from . import cnn

__all__ = ["cnn"]
