"""Deterministic synthetic data pipeline (checkpointable, shardable): a copy
of the JAX package's ``data/pipeline.py`` (numpy only), so both packages
draw bit-identical batches for the same seed and step.

No dataset files ship with the repository, so the pipeline generates
*learnable* token streams: an order-1 Markov chain with a low-entropy
transition structure derived from the seed.  Properties that matter for
the framework (and are tested):

* **deterministic**: batch(step) is a pure function of (seed, step) -- two
  hosts, or a restarted host, produce identical data;
* **checkpointable**: the pipeline state is a single step counter, saved in
  every checkpoint and restored on resume (no replayed or skipped batches);
* **shardable**: ``global_batch(step)`` returns the full array; hosts slice
  their data-parallel shard by index, so placement is exact on any mesh.

For the VLM/audio families the pipeline also emits the stub-frontend
embeddings (patch/frame features) as seeded gaussians.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from ..configs.base import ArchConfig

__all__ = ["PipelineState", "SyntheticPipeline"]


@dataclasses.dataclass
class PipelineState:
    step: int = 0

    def to_dict(self) -> Dict[str, int]:
        return {"data_step": self.step}

    @classmethod
    def from_dict(cls, d) -> "PipelineState":
        return cls(step=int(d["data_step"]))


class SyntheticPipeline:
    """Markov-chain token batches + modality stubs."""

    def __init__(
        self,
        cfg: ArchConfig,
        *,
        batch: int,
        seq: int,
        seed: int = 0,
        branching: int = 4,
    ):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.vocab = cfg.vocab
        # low-entropy transition table: from each token, only ``branching``
        # successors are likely -- a model that learns it beats uniform loss.
        rng = np.random.default_rng(seed)
        self._succ = rng.integers(0, self.vocab, size=(self.vocab, branching))
        self.state = PipelineState()

    # ------------------------------------------------------------------ #
    def _tokens_for(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        b, s = self.batch, self.seq
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=b)
        choices = rng.integers(0, self._succ.shape[1], size=(b, s))
        noise = rng.random((b, s)) < 0.05  # 5% uniform noise
        noise_tok = rng.integers(0, self.vocab, size=(b, s))
        for t in range(1, s):
            nxt = self._succ[toks[:, t - 1], choices[:, t]]
            toks[:, t] = np.where(noise[:, t], noise_tok[:, t], nxt)
        return toks

    def global_batch(self, step: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Full global batch for ``step`` (defaults to the cursor)."""
        step = self.state.step if step is None else step
        toks = self._tokens_for(step)
        batch: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1].copy(),
            "labels": toks[:, 1:].copy(),
        }
        rng = np.random.default_rng((self.seed, step, 7))
        if self.cfg.vision_tokens:
            batch["patch_embeds"] = rng.standard_normal(
                (self.batch, self.cfg.vision_tokens, self.cfg.d_model), np.float32
            )
        if self.cfg.is_encdec:
            batch["frames"] = rng.standard_normal(
                (self.batch, self.cfg.encoder_seq, self.cfg.d_model), np.float32
            )
        return batch

    def next(self) -> Dict[str, np.ndarray]:
        out = self.global_batch(self.state.step)
        self.state.step += 1
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()

    # ------------------------------------------------------------------ #
    def host_shard(
        self, batch: Dict[str, np.ndarray], host_id: int, n_hosts: int
    ) -> Dict[str, np.ndarray]:
        """Slice this host's data-parallel rows (exact, contiguous)."""
        per = self.batch // n_hosts
        sl = slice(host_id * per, (host_id + 1) * per)
        return {k: v[sl] for k, v in batch.items()}
