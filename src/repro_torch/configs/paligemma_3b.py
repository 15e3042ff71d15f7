"""paligemma-3b  [vlm] -- 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216 -- SigLIP (stub) + gemma backbone  [arXiv:2407.07726; hf].
The vision tower is a STUB per the assignment: input_specs() provides 256
precomputed patch embeddings [B, 256, D]; the LM runs prefix-LM attention
(bidirectional over the image prefix)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=257216,
    head_dim=256,
    vision_tokens=256,
    tie_embeddings=True,
    ffn_activation="gelu",   # gemma GeGLU
)
