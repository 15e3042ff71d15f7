"""Plan serving: :class:`PlanServer` (a port of ``repro.serving.engine``'s
``PlanServer``; the LM engine and the async scheduler come with later
slices).

Frames queue up and execute in fixed-size batches via
:meth:`ExecutionPlan.batched`, padding only the tail batch.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..obs import metrics as _metrics

__all__ = ["PlanServer"]


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
