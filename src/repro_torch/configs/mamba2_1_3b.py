"""mamba2-1.3b  [ssm] -- 48L d_model=2048 (attn-free) vocab=50280,
ssm_state=128 -- SSD (state-space duality)  [arXiv:2405.21060]."""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
)
