"""phi4-mini-3.8b  [dense] -- 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 -- RoPE SwiGLU GQA  [arXiv:2412.08905; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200064,
    ffn_activation="silu",
)
