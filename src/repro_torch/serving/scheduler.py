"""AsyncPlanServer, the LLM half: token-level continuous batching of a
prefill / decode plan pair over a paged KV-cache (a port of the
autoregressive part of ``repro.serving.scheduler``).

:meth:`AsyncPlanServer.add_llm` registers a prefill plan and a decode plan
(the two phases of ``models.transformer_graph.build_decoder_graph``) that
share a :class:`~.kvcache.PagedKVCache`; :meth:`AsyncPlanServer.submit_llm`
admits a prompt and returns a :class:`SequenceHandle` immediately.  Every
scheduler tick co-schedules one prefill batch (prompts admitted this tick)
and one decode step (every sequence already decoding), so a short prompt
starts decoding the tick after it arrives instead of waiting for a long
neighbour to finish generating.  Sequences wait in strict ``(-priority,
arrival)`` order -- no skip-ahead past a big prompt at the head -- and are
admitted when the batch has a slot and the cache has pages for the prompt;
they leave on EOS, ``max_new_tokens`` or failure, always releasing their
pages.  Ticks come from a background thread (:meth:`start`) or from
synchronous :meth:`step` calls (tests).

Device traffic per tick: the plans run on their device; each step's
logits are reduced to the greedy token there (``argmax`` of the row that
needs it) and only the token ids and the fresh per-layer k/v (stacked into
one tensor each) come back to the host, where the numpy pools live.

The frame side of the JAX package's server (``add_plan`` / ``submit``,
tenants and quotas, the SLO ladder, the watchdog and hot-swap) comes with
the serving slice; ``add_plan`` and ``submit`` raise ``NotImplementedError``
until then.  Counters are mirrored into the port's metrics registry
(``serving_events_total{plan, event}``, ``serving_latency_seconds{plan}``)
and each request is a trace span, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..obs import trace as _otrace
from .kvcache import CacheFullError, PagedKVCache

__all__ = ["AsyncPlanServer", "QueueFullError", "RequestHandle", "SequenceHandle"]


class QueueFullError(RuntimeError):
    """Raised by ``submit_llm`` when the model's queue is full."""


@dataclasses.dataclass(eq=False)
class RequestHandle:
    """Per-request future.  ``result()`` blocks until the scheduler (or a
    synchronous :meth:`AsyncPlanServer.step`) completes the request, then
    returns its value or raises the stored error."""

    rid: int
    plan: str
    priority: int = 0
    #: absolute deadline (engine clock); None = best effort
    deadline_at: Optional[float] = None
    submitted_at: float = 0.0
    completed_at: Optional[float] = None
    deadline_missed: bool = False

    def __post_init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} ({self.plan}) not done within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    def exception(self) -> Optional[BaseException]:
        return self._error if self._event.is_set() else None

    @property
    def latency(self) -> Optional[float]:
        """Submit-to-completion seconds (None while in flight)."""
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at

    # first verdict wins: a handle is resolved or failed once
    def _resolve(self, value, now: float) -> None:
        if self._event.is_set():
            return
        self.completed_at = now
        self.deadline_missed = self.deadline_at is not None and now > self.deadline_at
        self._value = value
        self._event.set()

    def _fail(self, err: BaseException, now: float) -> None:
        if self._event.is_set():
            return
        self.completed_at = now
        self._error = err
        self._event.set()


@dataclasses.dataclass(eq=False)
class SequenceHandle(RequestHandle):
    """Per-sequence future (``submit_llm``): one prefill batch caches the
    prompt and emits the first token, then every tick in the decode batch
    emits one more, until EOS or ``max_new_tokens``.  ``result()`` returns
    the generated token ids as an int32 array; :meth:`tokens_so_far`
    streams them while the sequence is live."""

    prompt: Tuple[int, ...] = ()
    max_new_tokens: int = 16
    #: stop token (None = run to max_new_tokens)
    eos_id: Optional[int] = None

    def __post_init__(self):
        super().__post_init__()
        self._generated: List[int] = []
        self._seq = 0  # arrival order within its model
        self._seq_id: Optional[int] = None  # KV-cache sequence id once admitted
        self._phase = "waiting"  # waiting -> decode -> (resolved)

    def tokens_so_far(self) -> Tuple[int, ...]:
        return tuple(self._generated)


@dataclasses.dataclass(eq=False)
class _LLMEntry:
    """One registered autoregressive model: prefill plan, decode plan and
    the paged KV-cache they share, with its waiting and active sequences."""

    name: str
    prefill: Any  # ExecutionPlan, phase="prefill" graph
    decode: Any  # ExecutionPlan, phase="decode" graph
    cache: PagedKVCache
    max_batch: int = 4
    eos_id: Optional[int] = None
    waiting: List[SequenceHandle] = dataclasses.field(default_factory=list)
    active: List[SequenceHandle] = dataclasses.field(default_factory=list)
    seq: int = 0  # arrival order AND KV-cache sequence ids
    queue_peak: int = 0
    busy: bool = False  # one tick works an entry at a time
    stats: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {
            "submitted": 0, "completed": 0, "failed": 0, "rejected": 0,
            "prefill_batches": 0, "decode_batches": 0, "decode_tokens": 0,
            "cache_full": 0, "deadline_misses": 0,
            # wall seconds of the plan calls, host transfers included
            "prefill_seconds": 0.0, "decode_seconds": 0.0,
        }
    )


def _kv_to_host(kvs: List[torch.Tensor]) -> Tuple[np.ndarray, np.ndarray]:
    """The per-layer k / v outputs (``[B, S, G*dh]`` each, interleaved k0,
    v0, k1, ...) as two host arrays ``[B, S, L, G*dh]`` in f32 (the pools'
    type; bf16 widens exactly) -- one device-to-host copy each."""
    k = torch.stack(kvs[0::2], dim=2).float().cpu().numpy()
    v = torch.stack(kvs[1::2], dim=2).float().cpu().numpy()
    return k, v


class AsyncPlanServer:
    """Async continuous-batching server over prefill / decode plan pairs.

    Deterministic use (tests; no thread)::

        server = AsyncPlanServer()
        server.add_llm("lm", prefill=plan_pre, decode=plan_dec, cache=cache)
        h = server.submit_llm("lm", prompt, max_new_tokens=8)
        while not h.done():
            server.step()
        tokens = h.result(0)

    Production use::

        with AsyncPlanServer() as server:
            server.add_llm(...); server.start()
            handles = [server.submit_llm("lm", p) for p in prompts]
            outs = [h.result() for h in handles]
    """

    def __init__(
        self,
        *,
        max_queue: int = 1024,
        tick_interval: float = 0.002,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.tick_interval = tick_interval
        self.closed = False
        self._clock = clock
        self._llms: Dict[str, _LLMEntry] = {}
        self._rid = 0
        self._batch_seq = 0  # trace-facing batch ids
        self._lock = threading.RLock()
        self._work = threading.Event()  # submit -> wake the scheduler thread
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._inflight = 0
        self._idle = threading.Condition(self._lock)

    @staticmethod
    def _bump(entry: _LLMEntry, event: str, amount: int = 1) -> None:
        """One stat increment, mirrored into ``serving_events_total``."""
        entry.stats[event] += amount
        if amount:
            _metrics.registry().counter(
                "serving_events_total", plan=entry.name, event=event
            ).inc(amount)

    # -- configuration ------------------------------------------------------- #
    def add_plan(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "frame plans (add_plan / submit) come with the serving slice of the port"
        )

    def submit(self, *args, **kwargs):
        raise NotImplementedError(
            "frame plans (add_plan / submit) come with the serving slice of the port"
        )

    def add_llm(
        self,
        name: str,
        *,
        prefill,
        decode,
        cache: PagedKVCache,
        max_batch: int = 4,
        eos_id: Optional[int] = None,
    ) -> None:
        """Register an autoregressive model: ``prefill`` / ``decode`` are the
        two compiled decoder plans and ``cache`` the :class:`PagedKVCache`
        of its sequences.  ``max_batch`` bounds concurrently active
        sequences; ``eos_id`` is the default stop token."""
        with self._lock:
            if self.closed:
                raise RuntimeError("AsyncPlanServer is closed")
            if name in self._llms:
                raise ValueError(f"{name!r} already registered")
            if max_batch < 1:
                raise ValueError(f"max_batch must be >= 1, got {max_batch}")
            n_pre = len(prefill.graph.inputs)
            n_dec = len(decode.graph.inputs)
            if n_pre != 3 or n_dec != 5:
                raise ValueError(
                    f"expected prefill(tokens, positions, lengths) and "
                    f"decode(tokens, positions, k_ctx, v_ctx, lengths) "
                    f"graphs; got {n_pre}/{n_dec} inputs"
                )
            self._llms[name] = _LLMEntry(
                name=name, prefill=prefill, decode=decode, cache=cache,
                max_batch=max_batch, eos_id=eos_id,
            )

    # -- admission ------------------------------------------------------------ #
    def submit_llm(
        self,
        name: str,
        prompt_tokens,
        *,
        max_new_tokens: int = 16,
        eos_id: Optional[int] = None,
        priority: int = 0,
        deadline: Optional[float] = None,
    ) -> SequenceHandle:
        """Queue one prompt for greedy generation on LLM ``name`` and return
        its :class:`SequenceHandle` immediately.  Overload is reject-only: a
        full queue raises :class:`QueueFullError` (a queued sequence is a
        future cache reservation, so it is never evicted); a prompt that
        could never fit the cache raises ``ValueError``."""
        prompt = tuple(int(x) for x in np.asarray(prompt_tokens).reshape(-1).tolist())
        if not prompt:
            raise ValueError("prompt_tokens must be non-empty")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        with self._lock:
            if self.closed:
                raise RuntimeError("AsyncPlanServer is closed; no further requests")
            entry = self._llms.get(name)
            if entry is None:
                raise KeyError(f"unknown llm {name!r}; registered: {sorted(self._llms)}")
            cache = entry.cache
            if cache.pages_for(len(prompt) + 1) > cache.num_pages:
                raise ValueError(
                    f"prompt of {len(prompt)} tokens can never fit the "
                    f"{cache.num_pages}x{cache.page_size}-token cache"
                )
            depth = len(entry.waiting) + len(entry.active)
            if depth >= self.max_queue:
                self._bump(entry, "rejected")
                raise QueueFullError(
                    f"llm {name!r} queue full ({depth}/{self.max_queue}); sequence rejected"
                )
            now = self._clock()
            handle = SequenceHandle(
                rid=self._rid, plan=name, priority=priority,
                deadline_at=None if deadline is None else now + deadline,
                submitted_at=now, prompt=prompt, max_new_tokens=max_new_tokens,
                eos_id=eos_id if eos_id is not None else entry.eos_id,
            )
            self._rid += 1
            handle._seq = entry.seq
            entry.seq += 1
            entry.waiting.append(handle)
            entry.waiting.sort(key=lambda h: (-h.priority, h._seq))
            self._bump(entry, "submitted")
            if depth + 1 > entry.queue_peak:
                entry.queue_peak = depth + 1
                _metrics.registry().gauge(
                    "serving_queue_depth_peak", plan=name
                ).set_max(entry.queue_peak)
            if _otrace.enabled():
                _otrace.async_begin(
                    "request", handle.rid, cat="serving", plan=name,
                    priority=priority, kind="sequence",
                )
        self._work.set()
        return handle

    def pending(self, name: Optional[str] = None) -> int:
        with self._lock:
            entries = [self._llms[name]] if name is not None else list(self._llms.values())
            return sum(len(e.waiting) + len(e.active) for e in entries)

    # -- scheduling ---------------------------------------------------------- #
    def step(self) -> int:
        """One synchronous scheduler tick over every registered LLM: at most
        one prefill batch and one decode step each.  Returns the number of
        batches run."""
        executed = 0
        for name in list(self._llms):
            executed += self._llm_tick(name)
        return executed

    def _llm_tick(self, name: str) -> int:
        """Admit waiting prompts while the batch has slots and the cache has
        pages, run ONE prefill batch over the newly admitted and ONE decode
        step over every sequence already decoding.  Compute runs with the
        admission lock released."""
        with self._lock:
            entry = self._llms.get(name)
            if entry is None or entry.busy:
                return 0
            admitted: List[SequenceHandle] = []
            while entry.waiting and len(entry.active) < entry.max_batch:
                h = entry.waiting[0]
                need = entry.cache.pages_for(len(h.prompt) + 1)
                if need > entry.cache.free_pages:
                    break  # strict order: no skip-ahead past a big prompt
                entry.waiting.pop(0)
                h._seq_id = h._seq
                entry.cache.allocate(h._seq_id)
                # reserve the prompt's pages now so the prefill append
                # cannot race another admission for them
                entry.cache.ensure_capacity(h._seq_id, len(h.prompt))
                entry.active.append(h)
                admitted.append(h)
            decoding = [h for h in entry.active if h._phase == "decode"]
            if not admitted and not decoding:
                return 0
            entry.busy = True
            self._inflight += 1
        executed = 0
        try:
            if admitted:
                self._llm_prefill(entry, admitted)
                executed += 1
            if decoding:
                self._llm_decode(entry, decoding)
                executed += 1
        finally:
            with self._lock:
                entry.busy = False
                self._inflight -= 1
                self._idle.notify_all()
        return executed

    def _next_batch_id(self) -> int:
        with self._lock:
            bid = self._batch_seq
            self._batch_seq += 1
            return bid

    def _llm_prefill(self, entry: _LLMEntry, batch: List[SequenceHandle]) -> None:
        """Run the prefill plan over the newly admitted prompts (padded to
        the longest, masked by per-row lengths), cache each sequence's
        per-layer KV, and emit each first greedy token."""
        cache = entry.cache
        lens = np.array([len(h.prompt) for h in batch], np.int32)
        s = int(lens.max())
        tokens = np.zeros((len(batch), s), np.int32)
        for j, h in enumerate(batch):
            tokens[j, : len(h.prompt)] = h.prompt
        positions = np.broadcast_to(np.arange(s, dtype=np.int32), tokens.shape).copy()
        bid = self._next_batch_id()
        t0 = time.perf_counter()
        with _otrace.span(
            "llm_prefill", cat="serving", plan=entry.name, batch=bid,
            rids=[h.rid for h in batch], tokens=int(lens.sum()),
        ):
            try:
                outs = entry.prefill(entry.prefill.graph.params, tokens, positions, lens)
                logits = outs[0]
                rows = torch.arange(len(batch), device=logits.device)
                last = torch.as_tensor(lens - 1, device=logits.device).long()
                nxt = logits[rows, last].argmax(dim=-1).cpu().numpy()
                k_host, v_host = _kv_to_host(list(outs[1:]))
            except Exception as e:
                now = self._clock()
                with self._lock:
                    for h in batch:
                        self._llm_fail(entry, h, e, now)
                return
        now = self._clock()
        g, dh = cache.n_kv_heads, cache.head_dim
        n_layers = k_host.shape[2]
        with self._lock:
            entry.stats["prefill_seconds"] += time.perf_counter() - t0
            self._bump(entry, "prefill_batches")
            for j, h in enumerate(batch):
                n = int(lens[j])
                cache.append(h._seq_id, k_host[j, :n].reshape(n, n_layers, g, dh),
                             v_host[j, :n].reshape(n, n_layers, g, dh))
                self._llm_emit(entry, h, int(nxt[j]), now)

    def _llm_decode(self, entry: _LLMEntry, batch: List[SequenceHandle]) -> None:
        """One decode step for every active sequence: gather the batch's
        paged KV spans, run the decode plan on each sequence's last emitted
        token, append the fresh KV, emit the next greedy token."""
        cache = entry.cache
        ok: List[SequenceHandle] = []
        now = self._clock()
        with self._lock:
            for h in batch:
                if h.done():  # finished in this tick's prefill pass
                    continue
                try:
                    cache.ensure_capacity(h._seq_id, cache.length(h._seq_id) + 1)
                    ok.append(h)
                except CacheFullError as e:
                    self._bump(entry, "cache_full")
                    self._llm_fail(entry, h, e, now)
        if not ok:
            return
        sids = [h._seq_id for h in ok]
        lengths = np.array([cache.length(sid) for sid in sids], np.int32)
        k_ctx, v_ctx, lens = cache.gather(sids, min_tokens=int(lengths.max()) + 1)
        tokens = np.array([[h._generated[-1]] for h in ok], np.int32)
        positions = lengths[:, None]
        bid = self._next_batch_id()
        t0 = time.perf_counter()
        with _otrace.span(
            "llm_decode", cat="serving", plan=entry.name, batch=bid,
            rids=[h.rid for h in ok],
        ):
            try:
                outs = entry.decode(
                    entry.decode.graph.params, tokens, positions, k_ctx, v_ctx, lens
                )
                nxt = outs[0][:, -1].argmax(dim=-1).cpu().numpy()
                k_host, v_host = _kv_to_host(list(outs[1:]))
            except Exception as e:
                now = self._clock()
                with self._lock:
                    for h in ok:
                        self._llm_fail(entry, h, e, now)
                return
        now = self._clock()
        g, dh = cache.n_kv_heads, cache.head_dim
        n_layers = k_host.shape[2]
        with self._lock:
            entry.stats["decode_seconds"] += time.perf_counter() - t0
            self._bump(entry, "decode_batches")
            self._bump(entry, "decode_tokens", len(ok))
            for j, h in enumerate(ok):
                cache.append(h._seq_id, k_host[j].reshape(1, n_layers, g, dh),
                             v_host[j].reshape(1, n_layers, g, dh))
                self._llm_emit(entry, h, int(nxt[j]), now)

    def _llm_emit(self, entry: _LLMEntry, h: SequenceHandle, tok: int, now: float) -> None:
        """Record one generated token and retire the sequence on EOS or
        length (call with the lock held)."""
        h._generated.append(tok)
        h._phase = "decode"
        if (h.eos_id is not None and tok == h.eos_id) or len(h._generated) >= h.max_new_tokens:
            entry.active.remove(h)
            entry.cache.release(h._seq_id)
            h._resolve(np.asarray(h._generated, np.int32), now)
            self._bump(entry, "completed")
            if h.deadline_missed:
                self._bump(entry, "deadline_misses")
            if h.latency is not None:
                _metrics.registry().histogram(
                    "serving_latency_seconds", plan=entry.name
                ).observe(h.latency)
            if _otrace.enabled():
                _otrace.async_end(
                    "request", h.rid, cat="serving", phase="completed",
                    tokens=len(h._generated),
                )

    def _llm_fail(self, entry: _LLMEntry, h: SequenceHandle, err: BaseException,
                  now: float) -> None:
        """Fail one sequence and release its pages (call with the lock
        held): a fault costs the affected sequences, never the engine."""
        if h in entry.active:
            entry.active.remove(h)
        if h._seq_id is not None and h._seq_id in entry.cache.sequences():
            entry.cache.release(h._seq_id)
        h._fail(err, now)
        self._bump(entry, "completed")
        self._bump(entry, "failed")
        if _otrace.enabled():
            _otrace.async_end("request", h.rid, cat="serving", phase="failed")

    # -- background thread --------------------------------------------------- #
    def start(self) -> "AsyncPlanServer":
        """Launch the scheduler thread (idempotent).  It ticks whenever work
        arrives and at least every ``tick_interval`` seconds."""
        with self._lock:
            if self.closed:
                raise RuntimeError("AsyncPlanServer is closed")
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, name="AsyncPlanServer",
                                            daemon=True)
            self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                executed = self.step()
            except Exception:  # a bad tick never kills the thread
                executed = 0
            if executed == 0:
                self._work.wait(self.tick_interval)
                self._work.clear()

    # -- teardown ------------------------------------------------------------ #
    def close(self) -> int:
        """Stop the scheduler thread, run every waiting and active sequence
        to its end (nothing accepted is dropped), and refuse further
        submits.  Returns the number of sequences the drain found pending.
        Idempotent; also runs on ``with`` exit."""
        with self._lock:
            if self.closed:
                return 0
            self.closed = True  # admission off first: the drain is bounded
            thread = self._thread
        if thread is not None:
            self._stop.set()
            self._work.set()
            thread.join()
            self._thread = None
        with self._lock:  # wait out any tick the thread left in flight
            while self._inflight:
                self._idle.wait()
        drained = self.pending()
        while self.pending():
            if not self.step():
                break  # nothing runnable: the sequences left cannot progress
        return drained

    def __enter__(self) -> "AsyncPlanServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- stats ---------------------------------------------------------------- #
    @property
    def stats(self) -> Dict[str, Any]:
        """``per_llm``: each model's counters (copies)."""
        with self._lock:
            return {"per_llm": {n: dict(e.stats) for n, e in self._llms.items()}}
