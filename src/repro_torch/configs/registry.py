"""Config registry: ``--arch <id>`` -> ArchConfig, plus reduced smoke configs
(the ``get_config`` / ``smoke_config`` / ``ARCH_IDS`` part of
``repro.configs.registry``).

The port lists the architectures whose model path it runs: the dense GQA
decoders qwen2.5-3b, granite-3-2b (head dim 64, tied embeddings) and
phi4-mini-3.8b (head dim 128, 3 query heads a KV group, a 200064-word
vocab).  The JAX package's other architectures (qk_norm, MoE, MLA, SSM,
hybrid, VLM, enc-dec) come with a later slice; ``get_config`` names them in
its error.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from .base import ArchConfig

ARCH_IDS: List[str] = ["qwen2.5-3b", "granite-3-2b", "phi4-mini-3.8b"]

_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "granite-3-2b": "granite_3_2b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
}

#: architectures of the JAX package whose model families are not ported yet
NOT_PORTED = (
    "qwen3-14b",
    "deepseek-v2-lite-16b",
    "deepseek-v2-236b",
    "paligemma-3b",
    "mamba2-1.3b",
    "whisper-small",
    "recurrentgemma-9b",
)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet; ported: {ARCH_IDS}"
        )
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; one of {ARCH_IDS}")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.CONFIG


def smoke_config(arch_id: str) -> ArchConfig:
    """Reduced same-family config: 2 layers, d_model 128, 4 heads (2 KV
    heads), head_dim 32, d_ff 256, vocab 256, f32 -- the values
    ``repro.configs.registry.smoke_config`` gives a dense GQA arch."""
    cfg = get_config(arch_id)
    n_kv = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 2
    if cfg.n_kv_heads == 1:
        n_kv = 1
    kw: Dict = dict(
        n_layers=2, d_model=128, vocab=256, dtype="float32",
        n_heads=4, n_kv_heads=n_kv, head_dim=32, d_ff=256,
    )
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
