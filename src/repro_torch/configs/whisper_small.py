"""whisper-small  [audio] -- 12L(enc)+12L(dec) d_model=768 12H d_ff=3072
vocab=51865 -- enc-dec, conv frontend STUB  [arXiv:2212.04356].
input_specs() provides precomputed frame embeddings [B, 1500, 768]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,          # decoder layers
    encoder_layers=12,
    encoder_seq=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    ffn_activation="gelu",
)
