"""Architecture + run configuration dataclasses (a copy of
``repro.configs.base``: plain data, no framework).

One ``ArchConfig`` per architecture lives in ``configs/<id>.py``.
``ShapeConfig`` describes the input-shape regimes.  Everything is a frozen
dataclass, so a config is hashable.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "RecurrentConfig", "ShapeConfig", "PruneConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int = 0
    n_shared: int = 0
    top_k: int = 2
    d_expert: int = 0  # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    #: layers [0, first_dense) use a dense FFN instead (DeepSeek-V2 layer 0)
    first_dense: int = 1
    router_aux_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    """Griffin/RecurrentGemma RG-LRU block config."""

    lru_width: int = 0  # 0 -> d_model
    d_conv: int = 4
    #: block pattern, e.g. ("rec", "rec", "attn") repeated  (1 attn : 2 rec)
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    window: int = 2048  # local-attention window for the attn blocks


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    """How the paper's technique is applied to this arch (None = dense)."""

    enabled: bool = False
    #: structure spec dicts per weight-class glob (see PrunePlan.from_rules)
    rules: Tuple[Tuple[str, Dict[str, Any]], ...] = ()
    #: execution mode: dense | masked | bsr | colpack
    exec_mode: str = "masked"
    sparsity: float = 0.5


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | ssm | audio | hybrid | cnn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention flavour
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # MLA (DeepSeek) -- 0 disables
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    # gated-FFN activation
    ffn_activation: str = "silu"  # silu -> SwiGLU, gelu -> GeGLU
    # subsystem configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    # enc-dec (whisper): encoder layer count (decoder = n_layers)
    encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper 30s @ 50 Hz after conv stub
    # vlm: number of image-prefix tokens from the (stub) vision tower
    vision_tokens: int = 0
    # norms / misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # paper technique
    prune: PruneConfig = PruneConfig()
    # compile strategy: unroll layers (exact HLO accounting) vs scan
    use_scan: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding/unembedding width: vocab rounded up to a 256 multiple so
        the vocab axis shards evenly on any mesh (padded logits are masked to
        -inf in the unembed -- see models/transformer._unembed)."""
        return -(-self.vocab // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.ssm is not None

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode state: SSM or bounded-window hybrid."""
        return self.ssm is not None or self.recurrent is not None


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
