"""Model graphs of the port: the paper's three demo CNN apps (``cnn``), the
decoder-only LMs of every family (``layers``, ``attention``, ``ffn``,
``ssm``, ``rglru``, ``transformer``), the encoder-decoder (``encdec``), the
dense decoder's plan lowering (``transformer_graph``), the uniform model
API (``registry.get_model``) and the mesh's sharding rules (``sharding``:
the same model code runs on DTensor params)."""

from . import attention, cnn, encdec, ffn, layers, rglru, sharding, ssm, transformer
from .registry import Model, get_model

__all__ = ["attention", "cnn", "encdec", "ffn", "layers", "rglru", "sharding", "ssm",
           "transformer", "Model", "get_model"]
