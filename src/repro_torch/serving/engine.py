"""Batched serving engine (a port of ``repro.serving.engine``): the LM
``Engine`` (prefill + decode over the uniform model API, greedy /
temperature sampling), the slot-based continuous-batching
``RequestScheduler``, and ``PlanServer`` for the vision apps' plans.

* :class:`Engine` -- ``generate(prompts, n, patch_embeds=None)``: one
  prefill filling every layer cache (a VLM's patch embeddings become the
  prefix), then single-token decode steps; every decoder-only family (its
  caches: GQA / MLA KV, Mamba-2 and RG-LRU states).  An encoder-decoder is
  refused, as the JAX engine refuses it: it runs through
  ``encdec.encode`` / ``precompute_cross_kv`` / ``decode_step``.  The
  engine runs the model's plain ``forward``-side functions
  (``transformer.prefill`` / ``decode_step``),
  as the JAX engine runs its jitted twins -- plain ``x @ w``, no kernel, in
  both packages; the plan-compiled decoder with the kernels is
  ``AsyncPlanServer.submit_llm`` (``scheduler.py``).  Temperature sampling
  draws from a ``torch.Generator`` seeded with ``seed`` (``jax.random``
  draws cannot be reproduced).  On DTensor params it serves on their
  mesh (the class's docstring says how).
* :class:`RequestScheduler` -- fixed-slot continuous batching: finished
  sequences release their slot, queued requests are prefilled one row at a
  time and spliced into the batched cache (every cache kind: each tensor of
  a layer's cache is batch-leading).  On an engine on a mesh the batched
  caches keep their decode placements and each rank writes the rows it
  holds (the class's docstring says how).
* :class:`PlanServer` -- frames queue up and execute in fixed-size batches
  via :meth:`ExecutionPlan.batched`, padding only the tail batch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import transformer as _lm
from ..models.sharding import broadcast_row, is_dtensor, place_rows, splice_row
from ..obs import metrics as _metrics

__all__ = ["GenerationResult", "Engine", "Request", "RequestScheduler", "PlanServer"]


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray  # [B, n_steps]
    logprobs: Optional[np.ndarray] = None


class Engine:
    """``model`` (a :class:`repro_torch.models.Model`) over ``params``:
    prompts of ``batch_size`` rows, caches of ``max_len`` slots.  Tensors go
    to the device of the params' embedding table.

    DTensor params (``sharding.distribute_params``; every rank builds the
    engine and calls ``generate`` with the same prompts) serve on their
    mesh, as the JAX package's jitted engine serves placed params: the
    prompts, the patch embeddings and each step's sampled token are cut
    over the batch (``sharding.place_rows``), the caches come back from
    ``prefill`` in their decode placements (``sharding.cache_pspecs``) and
    keep them from step to step, and the last logits ``[B, V]`` are made
    whole (``full_tensor``) only to sample, so every rank samples the same
    tokens."""

    def __init__(
        self,
        model,
        params: Any,
        *,
        batch_size: int,
        max_len: int,
        temperature: float = 0.0,
        seed: int = 0,
    ):
        if model.cfg.is_encdec:
            raise NotImplementedError(
                "Engine serves decoder-only models; run an encoder-decoder through "
                "encdec.encode / precompute_cross_kv / decode_step")
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.batch_size = batch_size
        self.max_len = max_len
        self.temperature = temperature
        table = params["embed"]["table"]
        self.device = table.device
        #: the params' mesh (DTensor params), else None
        self.mesh = table.device_mesh if is_dtensor(table) else None
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _rows(self, t) -> torch.Tensor:
        """``t`` on the engine's device; on a mesh cut over the batch."""
        t = torch.as_tensor(t, device=self.device)
        return t if self.mesh is None else place_rows(t, self.mesh)

    @staticmethod
    def _last(logits: torch.Tensor) -> torch.Tensor:
        """The last position's logits ``[B, V]``, whole on every rank."""
        last = logits[:, -1]
        return last.full_tensor() if is_dtensor(last) else last

    @torch.no_grad()
    def _prefill(self, params, tokens, patch_embeds=None):
        if patch_embeds is not None:
            patch_embeds = self._rows(patch_embeds)
        logits, caches = _lm.prefill(params, self.cfg, self._rows(tokens), self.max_len,
                                     patch_embeds=patch_embeds)
        return self._last(logits), caches

    @torch.no_grad()
    def _decode(self, params, tok_t, caches):
        logits, caches = _lm.decode_step(params, self.cfg, self._rows(tok_t), caches)
        return self._last(logits), caches

    # ------------------------------------------------------------------ #
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0.0:
            return logits.argmax(dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].to(torch.int32)

    def generate(self, prompts, n_steps: int, patch_embeds=None) -> GenerationResult:
        """``prompts [B, S]`` (int, ``B == batch_size``) -> ``n_steps`` new
        tokens a row (the first from the prefill's last logits); a VLM takes
        ``patch_embeds [B, P, D]`` as the prompt's prefix."""
        if prompts.shape[0] != self.batch_size:
            raise ValueError(f"generate: {prompts.shape[0]} prompts, batch_size "
                             f"{self.batch_size}")
        logits, caches = self._prefill(self.params, prompts, patch_embeds)
        tok = self._sample(logits)
        out = [tok]
        for _ in range(n_steps - 1):
            logits, caches = self._decode(self.params, tok[:, None], caches)
            tok = self._sample(logits)
            out.append(tok)
        return GenerationResult(tokens=np.stack([t.cpu().numpy() for t in out], axis=1))


class PlanServer:
    """Throughput serving of a compiled :class:`ExecutionPlan`.

    Submitted frames (single samples, no batch dim) accumulate in a queue;
    :meth:`flush` stacks them into one macro-batch and pushes it through
    ``plan.batched(batch_size)`` -- every chunk runs at the fixed batch
    shape, only the tail chunk carries padding.  Stats record the padding
    overhead.

    ``flush_after`` (seconds) is the latency deadline for low-traffic
    serving: once the *oldest* queued frame has waited that long, the next
    :meth:`submit` or :meth:`poll` auto-flushes the partial batch instead of
    blocking on batch fill.  :meth:`poll` hands its flush output straight
    back; only *submit-triggered* flushes (whose caller receives a frame
    index, not outputs) buffer into ``completed`` -- drain it with
    :meth:`drain_completed`.  Manual :meth:`flush`/:meth:`close` return
    their outputs directly.  ``clock`` is injectable for tests.  Frames are
    moved to the plan's device on submit.
    """

    def __init__(
        self,
        plan,
        params,
        batch_size: int,
        *,
        flush_after: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        name: str = "default",
    ):
        self.plan = plan
        self.params = params
        self.batch_size = batch_size
        #: label for this server's registry mirror (``plan=<name>`` on the
        #: ``serving_v1_events_total`` family)
        self.name = name
        self.batched = plan.batched(batch_size)
        self._pending: List[Tuple[torch.Tensor, ...]] = []
        self.closed = False
        self.flush_after = flush_after
        self._clock = clock
        self._oldest: Optional[float] = None
        #: outputs of *submit*-triggered deadline flushes, in flush order
        self.completed: List[Any] = []
        self.stats: Dict[str, int] = {
            "frames": 0, "batches": 0, "padded_frames": 0, "deadline_flushes": 0,
        }

    def submit(self, *frame_inputs) -> int:
        """Queue one frame (one tensor or array per graph input, sans batch
        dim).  Returns its index within the next flush.  With a
        ``flush_after`` deadline, a queue whose oldest frame has exceeded it
        is flushed (output appended to ``completed``) right after this frame
        joins."""
        if self.closed:
            raise RuntimeError("PlanServer is closed; no further frames accepted")
        if len(frame_inputs) != len(self.plan.graph.inputs):
            raise TypeError(
                f"plan expects {len(self.plan.graph.inputs)} inputs per frame, "
                f"got {len(frame_inputs)}"
            )
        if not self._pending:
            self._oldest = self._clock()
        self._pending.append(
            tuple(torch.as_tensor(f, device=self.plan.device) for f in frame_inputs)
        )
        idx = len(self._pending) - 1
        out = self._deadline_flush()
        if out is not None:
            # submit's caller only sees a frame index: buffer the outputs
            self.completed.append(out)
        return idx

    @property
    def pending(self) -> int:
        return len(self._pending)

    def _deadline_flush(self):
        if (
            self.closed
            or self.flush_after is None
            or self._oldest is None
            or not self._pending
            or self._clock() - self._oldest < self.flush_after
        ):
            return None
        out = self.flush()
        self.stats["deadline_flushes"] += 1
        _metrics.registry().counter(
            "serving_v1_events_total", plan=self.name, event="deadline_flushes"
        ).inc()
        return out

    def poll(self):
        """Deadline check: flush iff the oldest queued frame has waited at
        least ``flush_after`` seconds, returning the flushed outputs (or
        None)."""
        return self._deadline_flush()

    def drain_completed(self) -> List[Any]:
        """Hand over (and clear) the buffered submit-triggered flush
        outputs, oldest first."""
        done, self.completed = self.completed, []
        return done

    def flush(self):
        """Run all queued frames -- *including* a partial tail batch (the
        batched plan pads it; no frame is ever dropped).  Returns outputs
        stacked over the frame axis (a tuple when the plan has multiple
        outputs), or None when the queue is empty."""
        if not self._pending:
            return None
        frames, self._pending = self._pending, []
        self._oldest = None
        inputs = tuple(torch.stack([f[i] for f in frames]) for i in range(len(frames[0])))
        out = self.batched(self.params, *inputs)
        reg = _metrics.registry()
        for k, v in self.batched.last_stats.items():
            self.stats[k] = self.stats.get(k, 0) + v
            if v:  # mirror into the metrics registry
                reg.counter("serving_v1_events_total", plan=self.name, event=k).inc(v)
        return out

    def close(self):
        """Drain the queue (flushing any partial batch) and refuse further
        submits.  Returns the final flush's outputs (None if nothing was
        queued).  Idempotent; the server is marked closed even when the
        final flush raises."""
        try:
            return self.flush()
        finally:
            self.closed = True

    def __enter__(self) -> "PlanServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


# --------------------------------------------------------------------------- #
# continuous batching                                                          #
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S]
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class RequestScheduler:
    """Fixed-slot continuous batching over the decode step.

    Each slot owns one row of the batched cache.  When a request finishes
    (``max_new`` or ``eos_id``), the next queued request is prefilled alone
    and spliced into that row while the other slots keep decoding.  Every
    slot decodes at every step (a finished or empty row's output is
    ignored), greedily.  :meth:`run` returns the requests still holding a
    slot, as the JAX package's does: a finished request whose slot was
    refilled is not in the list.

    On an engine on a mesh (DTensor params) every rank runs the same loop
    over the same queue, as every rank calls ``Engine.generate``: the greedy
    tokens come from logits made whole on each rank, so every rank admits,
    finishes and refills the same slots.  A row's prefill keeps its one
    prompt row whole (1 does not divide the batch axes) and its caches cut
    over ``model``; the first admission repeats that row over each rank's
    rows of caches in their decode placements (``sharding.broadcast_row``)
    and a later one writes it into the rank that holds the slot
    (``sharding.splice_row``): nothing is gathered or all-gathered, and the
    caches stay cut over ``data`` (``B / data`` rows a rank, the whole batch
    where ``data`` does not divide it) as the engine's do.  The JAX
    package's scheduler, on params placed alike, leaves its batched caches
    whole over the batch (GSPMD broadcasts the batch-1 prefill's caches);
    the tokens are the same.
    """

    def __init__(self, engine: Engine, eos_id: Optional[int] = None):
        self.engine = engine
        self.eos_id = eos_id
        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * engine.batch_size
        self._caches = None
        self._last_tok = np.zeros((engine.batch_size,), np.int32)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if (slot is None or slot.done) and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                # single-row prefill: run the row through prefill and splice
                logits, caches = self.engine._prefill(
                    self.engine.params, torch.as_tensor(req.prompt[None, :]))
                tok = int(logits.argmax(dim=-1)[0])
                req.generated.append(tok)
                self._last_tok[i] = tok
                if self._caches is None:
                    # first admission: broadcast the row's cache to the batch
                    self._caches = [broadcast_row(c, self.engine.batch_size) for c in caches]
                else:
                    # in place: the scheduler owns its batched caches (each
                    # decode step returns new ones), so no copy of the whole
                    # cache is made per admission -- nor, on a mesh, gathered
                    for full, row in zip(self._caches, caches):
                        splice_row(full, row, i)

    def step(self) -> bool:
        """One decode tick over all active slots.  Returns False when idle."""
        self._admit()
        active = [s for s in self.slots if s is not None and not s.done]
        if not active:
            return False
        logits, self._caches = self.engine._decode(
            self.engine.params, torch.as_tensor(self._last_tok[:, None]), self._caches)
        toks = logits.argmax(dim=-1).cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            t = int(toks[i])
            req.generated.append(t)
            self._last_tok[i] = t
            if len(req.generated) >= req.max_new or (
                self.eos_id is not None and t == self.eos_id
            ):
                req.done = True
        return True

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        for _ in range(max_ticks):
            if not self.step() and not self.queue:
                break
        return [s for s in self.slots if s is not None]

