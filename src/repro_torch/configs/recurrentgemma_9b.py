"""recurrentgemma-9b  [hybrid] -- 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000 -- RG-LRU + local attn 1:2  [arXiv:2402.19427].
Block pattern (rec, rec, attn) repeating; local window 2048."""
from .base import ArchConfig, RecurrentConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    recurrent=RecurrentConfig(
        lru_width=4096,
        d_conv=4,
        pattern=("rec", "rec", "attn"),
        window=2048,
    ),
    tie_embeddings=True,
    ffn_activation="gelu",
)
