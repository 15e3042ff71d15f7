"""deepseek-v2-236b  [moe] -- 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400, MoE 160 routed top-6 + 2 shared, MLA kv_lora=512 q_lora=1536
[arXiv:2405.04434; hf].  Layer 0 dense FFN (d_ff = 12288)."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,           # dense-FFN layers (layer 0)
    vocab=102400,
    head_dim=128,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    moe=MoEConfig(
        n_routed=160,
        n_shared=2,
        top_k=6,
        d_expert=1536,
        first_dense=1,
    ),
    ffn_activation="silu",
)
