"""Config registry: ``--arch <id>`` -> ArchConfig, plus reduced smoke configs
(a port of ``repro.configs.registry``).

``get_config(arch_id)`` returns the full-size config, ``smoke_config`` a
same-family reduced config (2-3 layers, d_model 128, a 256-word vocab, few
experts, f32) that runs a forward, a decode step and a train step on the CPU
in seconds, and ``shape_cells`` the arch's row of the (shape, status)
matrix.  The ten ids are the JAX package's, in its order: the dense GQA
decoders (qwen2.5-3b, qwen3-14b with qk_norm, granite-3-2b, phi4-mini-3.8b),
the MLA + MoE decoders (deepseek-v2-lite-16b, deepseek-v2-236b), the
prefix-LM VLM (paligemma-3b), Mamba-2 (mamba2-1.3b), the encoder-decoder
(whisper-small) and the RG-LRU hybrid (recurrentgemma-9b).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from .base import SHAPES, ArchConfig, RecurrentConfig, SSMConfig

ARCH_IDS: List[str] = [
    "qwen2.5-3b",
    "qwen3-14b",
    "granite-3-2b",
    "phi4-mini-3.8b",
    "deepseek-v2-lite-16b",
    "deepseek-v2-236b",
    "paligemma-3b",
    "mamba2-1.3b",
    "whisper-small",
    "recurrentgemma-9b",
]

_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "qwen3-14b": "qwen3_14b",
    "granite-3-2b": "granite_3_2b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "paligemma-3b": "paligemma_3b",
    "mamba2-1.3b": "mamba2_1_3b",
    "whisper-small": "whisper_small",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; one of {ARCH_IDS}")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.CONFIG


def smoke_config(arch_id: str) -> ArchConfig:
    """Reduced same-family config: 2-3 layers, narrow, tiny vocab (the values
    ``repro.configs.registry.smoke_config`` gives)."""
    cfg = get_config(arch_id)
    kw: Dict = dict(
        n_layers=3 if (cfg.recurrent or cfg.moe) else 2,
        d_model=128,
        vocab=256,
        dtype="float32",
    )
    if cfg.family == "ssm":
        kw.update(n_heads=0, n_kv_heads=0, d_ff=0,
                  ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=16))
    else:
        n_kv = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 2
        if cfg.n_kv_heads == 1:
            n_kv = 1
        kw.update(n_heads=4, n_kv_heads=n_kv, head_dim=32, d_ff=256)
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_routed=8, n_shared=cfg.moe.n_shared, top_k=2, d_expert=64
        )
        kw["kv_lora_rank"] = 32 if cfg.kv_lora_rank else 0
        kw["q_lora_rank"] = 48 if cfg.q_lora_rank else 0
        kw["rope_head_dim"] = 16 if cfg.kv_lora_rank else cfg.rope_head_dim
    if cfg.recurrent:
        kw["recurrent"] = RecurrentConfig(
            lru_width=128, d_conv=4, pattern=cfg.recurrent.pattern, window=32
        )
    if cfg.is_encdec:
        kw.update(n_layers=2, encoder_layers=2, encoder_seq=64)
    if cfg.vision_tokens:
        kw["vision_tokens"] = 16
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)


def shape_cells(arch_id: str) -> Dict[str, str]:
    """The (shape, status) matrix row for one arch: "run" or "SKIP(reason)".
    ``long_500k`` needs a sub-quadratic decode state: SSM or hybrid only."""
    cfg = get_config(arch_id)
    cells = {}
    for name in SHAPES:
        if name == "long_500k" and not cfg.supports_long_context:
            cells[name] = "SKIP(full-attention arch: 512k dense KV is not sub-quadratic)"
        else:
            cells[name] = "run"
    return cells
