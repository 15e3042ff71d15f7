"""Model graphs of the port: the paper's three demo CNN apps (``cnn``) and
the dense GQA decoder (``layers``, ``attention``, ``ffn``, ``transformer``,
its plan lowering ``transformer_graph``, and the uniform model API
``registry.get_model``)."""

from . import cnn
from .registry import Model, get_model

__all__ = ["cnn", "Model", "get_model"]
