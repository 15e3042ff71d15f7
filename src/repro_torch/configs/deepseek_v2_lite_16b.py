"""deepseek-v2-lite-16b  [moe] -- 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400, MoE 64 routed top-6 + 2 shared, MLA kv_lora=512
[arXiv:2405.04434; hf].  Layer 0 uses a dense FFN (d_ff = 10944)."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,           # dense-FFN layers (layer 0)
    vocab=102400,
    head_dim=128,
    kv_lora_rank=512,
    q_lora_rank=0,        # lite: no q compression
    rope_head_dim=64,
    moe=MoEConfig(
        n_routed=64,
        n_shared=2,
        top_k=6,
        d_expert=1408,
        first_dense=1,
    ),
    ffn_activation="silu",
)
