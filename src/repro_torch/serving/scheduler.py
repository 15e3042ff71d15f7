"""AsyncPlanServer: an async continuous-batching engine over execution
plans (a port of ``repro.serving.scheduler``: the frame side and the
autoregressive side).

* :meth:`AsyncPlanServer.submit` returns a :class:`RequestHandle`
  (future-like) immediately; the caller blocks on ``handle.result()`` only
  when it actually needs the output.
* a tick-driven scheduler forms macro-batches *continuously* from the
  admission queues -- a batch launches as soon as it is full, or as soon as
  latency pressure (the engine-level ``flush_after`` or a request-level
  ``deadline``) says a partial batch beats waiting.  Ticks come from a
  background thread (:meth:`start`) or from explicit synchronous
  :meth:`step` calls, which is what deterministic tests drive (the clock is
  injectable for the same reason).
* one server hosts **many plans**: each plan gets its own admission queue
  + :class:`BatchedPlan`, and each tick round-robins over the ready queues
  so a flood on one plan cannot starve the others.
* admission is **bounded**: a full queue either rejects the new request
  (``overload="reject"``, raises :class:`QueueFullError`) or sheds
  whichever of queue + {incoming} would be scheduled last -- lowest
  priority class, newest arrival (``overload="shed"``: an evicted queued
  handle fails with :class:`QueueFullError`; an incoming request that is
  itself the victim raises at ``submit``).

Request lifecycle::

    submit() -> queued -> [scheduler tick picks it] -> executing -> done
        |                                                  handle.result()
        +-> rejected/shed (handle raises QueueFullError)

Scheduling policy per tick, per plan: (1) full batch ready; (2) latency
release -- oldest queued request older than ``flush_after``, or any queued
request's absolute deadline within ``deadline_margin``; (3) otherwise the
queue waits.  Within a plan, requests are picked by ``(-priority,
arrival)``, due deadlines first, the rest by weighted deficit round-robin
across tenants.

The device: a batch's verdict waits for its kernels.  ``compute()`` moves
the batch's frames to the plan's device (numpy arrays and CPU tensors are
copied there), runs the chunk, records a CUDA event after it and waits on
that event, so a request's latency is its kernels' completion, not their
enqueue, and the ``watchdog`` sees a slow batch.  The watchdog cannot
cancel a kernel: a batch that outlives it fails its own handles with
:class:`WatchdogTimeout` and is abandoned to its worker thread, whose
kernels stay queued on the stream ahead of later batches.

Multi-tenancy (``serving/tenancy.py`` + ``serving/rollout.py``):
``submit(tenant=...)`` routes through that tenant's token-bucket quota
(:class:`QuotaExceededError`); batch membership is chosen by **weighted
deficit round-robin across tenant queues**; every plan is a stack of
:class:`~repro_torch.serving.rollout.PlanVersion` runnables so
:meth:`AsyncPlanServer.swap_plan` hot-swaps a plan with zero request loss
(admitted requests finish on their admitted version, old versions retire
when drained, a failed probe rolls back); and each tenant's SLO drives the
graceful-degradation **ladder** (shrink flush_after -> demote to the
registered cheaper variant -> shed lowest-priority admissions).

Autoregressive serving: :meth:`AsyncPlanServer.add_llm` registers a
prefill plan and a decode plan (the two phases of
``models.transformer_graph.build_decoder_graph``) that share a
:class:`~.kvcache.PagedKVCache`; :meth:`AsyncPlanServer.submit_llm` admits
a prompt and returns a :class:`SequenceHandle`.  Every tick co-schedules
one prefill batch (prompts admitted this tick) and one decode step (every
sequence already decoding).  Sequences wait in strict ``(-priority,
arrival)`` order -- no skip-ahead past a big prompt at the head -- and
leave on EOS, ``max_new_tokens`` or failure, always releasing their pages.
Each step's logits are reduced to the greedy token on the device; only the
token ids and the fresh per-layer k/v come back to the host, where the
numpy pools live.

Every per-plan counter bump is mirrored into the port's metrics registry
(``serving_events_total{plan, event}``, ``serving_latency_seconds{plan}``,
``serving_queue_depth_peak{plan}``, the tenant and ladder families); under
tracing each request is an async span and each macro-batch a duration span.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..obs import trace as _otrace
from ..utils.retry import retry_call
from .kvcache import CacheFullError, PagedKVCache
from .rollout import PlanVersion, SwapError, probe_version, version_health
from .tenancy import LADDER_LEVELS, DeficitRoundRobin, LadderConfig, Tenant, TenantSLO, TokenBucket

__all__ = [
    "AsyncPlanServer",
    "FrameSpecError",
    "LadderShedError",
    "QueueFullError",
    "QuotaExceededError",
    "RequestHandle",
    "SequenceHandle",
    "SwapError",
    "WatchdogTimeout",
    "submit_with_retry",
]


class QueueFullError(RuntimeError):
    """Raised by ``submit`` / ``submit_llm`` under the reject policy;
    stored on the shed handle under the shed policy."""


class QuotaExceededError(QueueFullError):
    """Raised by ``submit`` when the tenant's token bucket is exhausted.
    A ``QueueFullError`` subclass on purpose: quota throttling is
    transient (the bucket refills), so :func:`submit_with_retry` rides it
    out exactly like queue backpressure."""


class LadderShedError(QueueFullError):
    """Raised by ``submit`` when the tenant sits on the ladder's shed rung
    and the request's priority class is below the shed threshold -- the
    explicit overload response of last resort, counted per tenant."""


class FrameSpecError(ValueError):
    """Raised by ``submit`` when a frame's shape/dtype disagrees with the
    plan's input spec -- the malformed request fails *at admission*, so it
    can never poison the macro-batch it would have joined."""


class WatchdogTimeout(RuntimeError):
    """Stored on every handle of a batch whose execution exceeded the
    server's per-batch watchdog deadline.  Only that batch fails; the
    scheduler thread keeps ticking."""


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


@dataclasses.dataclass(eq=False)
class RequestHandle:
    """Per-request future.  ``result()`` blocks until the scheduler (or a
    synchronous :meth:`AsyncPlanServer.step`) completes the request, then
    returns the plan output for this single frame (batch dim stripped) or
    raises the stored error (shed under backpressure, execution failure)."""

    rid: int
    plan: str
    priority: int = 0
    #: admitting tenant (fair-share / quota / SLO accounting key)
    tenant: str = "default"
    #: absolute deadline (engine clock); None = best effort
    deadline_at: Optional[float] = None
    submitted_at: float = 0.0
    completed_at: Optional[float] = None
    deadline_missed: bool = False

    def __post_init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._inputs: Optional[Tuple[Any, ...]] = None  # cleared at dispatch
        self._seq = 0  # arrival order within its plan
        #: PlanVersion this request was admitted to; it executes there no
        #: matter what swap_plan installs afterwards
        self._runner: Optional[PlanVersion] = None

    # -- caller side --------------------------------------------------------- #
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

    # -- scheduler side ------------------------------------------------------ #
    # _resolve/_fail are idempotent (first verdict wins): a batch the
    # watchdog abandoned must never have its handles re-resolved if the
    # slow worker eventually limps home.
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
        self._seq_id: Optional[int] = None  # KV-cache sequence id once admitted
        self._phase = "waiting"  # waiting -> decode -> (resolved)

    def tokens_so_far(self) -> Tuple[int, ...]:
        return tuple(self._generated)


#: bounded completion-side buffers: a server nobody drains must plateau,
#: not ramp -- the admission queue bounds the inflow, these bound the wake
RETAINED_COMPLETIONS = 4096
LATENCY_RESERVOIR = 4096


@dataclasses.dataclass(eq=False)
class _PlanEntry:
    name: str
    #: the active PlanVersion new admissions route to (swap_plan replaces)
    primary: PlanVersion
    queue: List[RequestHandle] = dataclasses.field(default_factory=list)
    seq: int = 0  # FIFO tiebreak within a priority class
    #: high-water mark of the admission queue (never resets)
    queue_peak: int = 0
    #: per-input (shape, dtype) submit() validates against; given at
    #: add_plan or latched from the first accepted frame
    input_spec: Optional[Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]] = None
    #: registered degradation variants (the ladder's demotion targets)
    variants: Dict[str, PlanVersion] = dataclasses.field(default_factory=dict)
    #: the variant name rung-2 demotions route to (last registered with
    #: ladder_target=True)
    ladder_variant: Optional[str] = None
    #: swapped-out versions still owed verdicts; retired when drained
    draining: List[PlanVersion] = dataclasses.field(default_factory=list)
    version_seq: int = 0
    #: weighted fair-share selector over this plan's tenant sub-queues
    drr: DeficitRoundRobin = dataclasses.field(default_factory=DeficitRoundRobin)
    latencies: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=LATENCY_RESERVOIR)
    )
    stats: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {
            "submitted": 0, "completed": 0, "batches": 0, "padded_frames": 0,
            "rejected": 0, "shed": 0, "deadline_flushes": 0,
            "deadline_misses": 0, "bad_frames": 0, "watchdog_timeouts": 0,
            "swaps": 0, "swap_rollbacks": 0, "versions_retired": 0,
            "demoted_admissions": 0,
        }
    )

    # views of the active version's runnable
    @property
    def plan(self):
        return self.primary.plan

    @property
    def params(self):
        return self.primary.params

    @property
    def batched(self):
        return self.primary.batched


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
    latencies: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=LATENCY_RESERVOIR)
    )
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


def _wait_for_device(device: torch.device) -> None:
    """Block until the work queued so far on ``device``'s current stream is
    done: a CUDA event recorded now, then waited on (a no-op on the CPU)."""
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        ev.synchronize()


class AsyncPlanServer:
    """Async continuous-batching server over compiled frame plans and
    prefill / decode plan pairs.

    Deterministic use (tests; no thread)::

        server = AsyncPlanServer(clock=fake_clock)
        server.add_plan("style", plan, params, batch_size=4)
        h = server.submit("style", frame)
        server.step()          # one scheduler tick
        y = h.result(0)

    Production use::

        with AsyncPlanServer(flush_after=0.01) as server:
            server.add_plan(...); server.start()
            handles = [server.submit(app, f) for app, f in traffic]
            outs = [h.result() for h in handles]
    """

    def __init__(
        self,
        *,
        flush_after: Optional[float] = None,
        deadline_margin: float = 0.0,
        max_queue: int = 1024,
        overload: str = "reject",
        tick_interval: float = 0.002,
        watchdog: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if overload not in ("reject", "shed"):
            raise ValueError(f"overload policy {overload!r}: want reject|shed")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if watchdog is not None and watchdog <= 0:
            raise ValueError(f"watchdog must be > 0 seconds, got {watchdog}")
        self.flush_after = flush_after
        self.deadline_margin = deadline_margin
        self.max_queue = max_queue
        self.overload = overload
        self.tick_interval = tick_interval
        #: per-batch execution deadline (wall seconds); a batch that blows it
        #: fails its own handles with WatchdogTimeout and is abandoned to a
        #: daemon thread -- the scheduler moves on
        self.watchdog = watchdog
        self.closed = False
        self._tick_errors = 0  # scheduler-tick exceptions survived by _loop
        self._clock = clock
        self._plans: Dict[str, _PlanEntry] = {}
        self._llms: Dict[str, _LLMEntry] = {}
        #: tenants by name; "default" always exists (unit weight, no quota,
        #: no SLO) so single-tenant callers never see the machinery
        self._tenants: Dict[str, Tenant] = {"default": Tenant("default")}
        self._rr = 0  # round-robin start index over plan names
        self._rid = 0
        self._batch_seq = 0  # trace-facing macro-batch ids
        self._lock = threading.RLock()
        self._work = threading.Event()  # submit -> wake the scheduler thread
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._inflight = 0
        self._idle = threading.Condition(self._lock)
        #: completed handles not yet handed over via drain_completed(),
        #: bounded to the most recent RETAINED_COMPLETIONS
        self._completed: Deque[RequestHandle] = deque(maxlen=RETAINED_COMPLETIONS)

    @staticmethod
    def _bump(entry, event: str, amount: int = 1) -> None:
        """One stat increment, mirrored into the registry family
        ``serving_events_total{plan, event}``."""
        entry.stats[event] += amount
        if amount:
            _metrics.registry().counter(
                "serving_events_total", plan=entry.name, event=event
            ).inc(amount)

    @staticmethod
    def _bump_tenant(t: Tenant, event: str, amount: int = 1) -> None:
        """Per-tenant sibling of :meth:`_bump`, mirrored into
        ``serving_tenant_events_total{tenant, event}``."""
        t.stats[event] += amount
        if amount:
            _metrics.registry().counter(
                "serving_tenant_events_total", tenant=t.name, event=event
            ).inc(amount)

    # -- configuration ------------------------------------------------------- #
    def add_plan(
        self,
        name: str,
        plan,
        params,
        batch_size: int,
        *,
        via_vmap: bool = False,
        input_spec: Optional[Sequence[Tuple[Sequence[int], Any]]] = None,
    ) -> None:
        """Register a plan under ``name`` with its own admission queue and
        fixed batch size.  All registered plans share the scheduler (and its
        fairness rotation).  ``input_spec`` -- one ``(shape, dtype)`` per
        graph input (frame form, no batch dim; a torch or numpy dtype) --
        makes :meth:`submit` reject malformed frames immediately; without it
        the spec is latched from the first accepted frame."""
        with self._lock:
            if self.closed:
                raise RuntimeError("AsyncPlanServer is closed")
            if name in self._plans:
                raise ValueError(f"plan {name!r} already registered")
            spec = None
            if input_spec is not None:
                spec = tuple(
                    (tuple(int(d) for d in shape), _torch_dtype(dtype))
                    for shape, dtype in input_spec
                )
                if len(spec) != len(plan.graph.inputs):
                    raise ValueError(
                        f"input_spec has {len(spec)} entries; plan has "
                        f"{len(plan.graph.inputs)} inputs"
                    )
            self._plans[name] = _PlanEntry(
                name=name,
                primary=PlanVersion(
                    plan=plan, params=params,
                    batched=plan.batched(batch_size, via_vmap=via_vmap), version=0,
                ),
                input_spec=spec,
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
        two compiled decoder plans (any backend) and ``cache`` the
        :class:`PagedKVCache` of its sequences.  ``max_batch`` bounds
        concurrently active sequences; ``eos_id`` is the default stop
        token."""
        with self._lock:
            if self.closed:
                raise RuntimeError("AsyncPlanServer is closed")
            if name in self._llms or name in self._plans:
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

    def add_tenant(
        self,
        name: str,
        *,
        weight: float = 1.0,
        rate: Optional[float] = None,
        burst: Optional[float] = None,
        slo: Optional[TenantSLO] = None,
        ladder: Optional[LadderConfig] = None,
    ) -> None:
        """Register a tenant: ``weight`` sets its fair share of batch slots
        (deficit round-robin), ``rate``/``burst`` its token-bucket admission
        quota (tokens/s; None = unlimited), ``slo`` + ``ladder`` its
        degradation policy.  ``submit(tenant=...)`` requires the name to be
        registered; re-registering "default" re-configures the built-in
        tenant."""
        with self._lock:
            if self.closed:
                raise RuntimeError("AsyncPlanServer is closed")
            if name in self._tenants and name != "default":
                raise ValueError(f"tenant {name!r} already registered")
            self._tenants[name] = Tenant(
                name=name, weight=weight, bucket=TokenBucket(rate, burst),
                slo=slo, ladder=ladder or LadderConfig(),
            )
            _metrics.registry().gauge("serving_ladder_level", tenant=name).set(0)

    def register_variant(
        self,
        plan_name: str,
        variant: str,
        plan,
        params,
        *,
        batch_size: Optional[int] = None,
        via_vmap: bool = False,
        ladder_target: bool = True,
    ) -> None:
        """Register a cheaper runnable of ``plan_name`` (re-quantized,
        guarded-reference, smaller) under the label ``variant``.  With
        ``ladder_target=True`` (default) it becomes the rung-2 demotion
        target: a tenant escalated to ``demote_plan`` has its *new*
        admissions routed here until it recovers."""
        with self._lock:
            if self.closed:
                raise RuntimeError("AsyncPlanServer is closed")
            entry = self._plans.get(plan_name)
            if entry is None:
                raise KeyError(f"unknown plan {plan_name!r}")
            if variant in entry.variants or variant == "primary":
                raise ValueError(f"variant {variant!r} already registered for {plan_name!r}")
            entry.variants[variant] = PlanVersion(
                plan=plan, params=params,
                batched=plan.batched(batch_size or entry.primary.batch_size, via_vmap=via_vmap),
                version=0, variant=variant,
            )
            if ladder_target:
                entry.ladder_variant = variant

    def swap_plan(
        self,
        name: str,
        plan,
        params,
        *,
        batch_size: Optional[int] = None,
        via_vmap: bool = False,
        probe_frames: Optional[Sequence[Any]] = None,
        parity_tol: Optional[float] = None,
    ) -> int:
        """Atomically install a new version of plan ``name`` with **zero
        request loss**: requests admitted before the swap finish on the
        version that admitted them, new admissions route to the new
        version, and the old version retires once its outstanding count
        drains to zero (counted + traced).  The incoming version is probed
        first -- one batch must execute with finite outputs (and, when
        ``parity_tol`` is given, stay within it of the live version on the
        same frames); a failed probe raises :class:`SwapError` and **rolls
        back** (the live version never stops serving).  Returns the new
        version id."""
        with self._lock:
            if self.closed:
                raise RuntimeError("AsyncPlanServer is closed")
            entry = self._plans.get(name)
            if entry is None:
                raise KeyError(f"unknown plan {name!r}")
            old = entry.primary
            entry.version_seq += 1
            incoming = PlanVersion(
                plan=plan, params=params,
                batched=plan.batched(batch_size or old.batch_size, via_vmap=via_vmap),
                version=entry.version_seq,
            )
            spec = entry.input_spec
        # probe outside the lock: it executes a real batch and admission
        # must keep flowing to the live version
        try:
            probe_version(incoming, spec, probe_frames, reference=old, parity_tol=parity_tol)
        except SwapError:
            with self._lock:
                self._bump(entry, "swap_rollbacks")
                _metrics.registry().counter(
                    "serving_swap_total", plan=name, event="rolled_back"
                ).inc()
            _otrace.instant("plan_swap", cat="serving", plan=name,
                            version=incoming.version, event="rolled_back")
            raise
        with self._lock:
            if entry.primary is not old:
                # a concurrent swap won while we probed: treat ours as a
                # rollback rather than silently clobbering the winner
                self._bump(entry, "swap_rollbacks")
                _metrics.registry().counter(
                    "serving_swap_total", plan=name, event="rolled_back"
                ).inc()
                raise SwapError(
                    f"plan {name!r} was swapped concurrently; version "
                    f"{incoming.version} not installed"
                )
            entry.primary = incoming
            self._bump(entry, "swaps")
            _metrics.registry().counter("serving_swap_total", plan=name, event="installed").inc()
            entry.draining.append(old)
            self._maybe_retire(entry)
        _otrace.instant("plan_swap", cat="serving", plan=name,
                        version=incoming.version, event="installed")
        self._work.set()
        return incoming.version

    def _maybe_retire(self, entry: _PlanEntry) -> None:
        """Retire drained old versions (call with the lock held)."""
        still: List[PlanVersion] = []
        for v in entry.draining:
            if v.outstanding <= 0:
                self._bump(entry, "versions_retired")
                _metrics.registry().counter(
                    "serving_swap_total", plan=entry.name, event="retired"
                ).inc()
                _otrace.instant("plan_swap", cat="serving", plan=entry.name,
                                version=v.version, event="retired")
            else:
                still.append(v)
        entry.draining = still

    @property
    def plans(self) -> Tuple[str, ...]:
        return tuple(self._plans)

    @property
    def llms(self) -> Tuple[str, ...]:
        return tuple(self._llms)

    @property
    def tenants(self) -> Tuple[str, ...]:
        return tuple(self._tenants)

    # -- admission ----------------------------------------------------------- #
    def _tenant(self, tenant: Optional[str]) -> Tenant:
        tname = tenant if tenant is not None else "default"
        t = self._tenants.get(tname)
        if t is None:
            raise KeyError(f"unknown tenant {tname!r}; registered: {sorted(self._tenants)}")
        return t

    def _admit_tenant(self, t: Tenant, priority: int, now: float) -> None:
        """The tenant's gates, in order (call with the lock held): the
        ladder's shed rung turns the lowest priority classes away before
        they can consume a token, then the token bucket."""
        if t.level >= LADDER_LEVELS.index("shed") and priority < t.ladder.shed_below_priority:
            self._bump_tenant(t, "ladder_shed")
            raise LadderShedError(
                f"tenant {t.name!r} is on the {t.level_name!r} rung; "
                f"priority {priority} admissions "
                f"(< {t.ladder.shed_below_priority}) are shed"
            )
        if not t.bucket.take(now):
            self._bump_tenant(t, "throttled")
            raise QuotaExceededError(
                f"tenant {t.name!r} quota exhausted "
                f"({t.bucket.rate}/s, burst {t.bucket.burst})"
            )

    def submit(
        self,
        plan_name: str,
        *frame_inputs,
        priority: int = 0,
        deadline: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> RequestHandle:
        """Queue one frame for ``plan_name`` (one array or tensor per graph
        input, no batch dim) and return its :class:`RequestHandle`
        immediately.  ``deadline`` is a per-request latency budget in
        seconds (relative to now); a near deadline releases a partial batch
        early, and a late completion is counted in ``deadline_misses``.  A
        full queue follows the overload policy: ``reject`` raises
        :class:`QueueFullError`; ``shed`` drops whichever of queue + {this
        request} would be scheduled last (lowest priority class, newest
        arrival) -- an evicted queued handle fails with
        :class:`QueueFullError`, while an incoming request that is itself
        the victim raises here.

        ``tenant`` names a registered tenant (None = the built-in
        "default"): its token bucket gates admission
        (:class:`QuotaExceededError`), its ladder rung may shed a
        low-priority request outright (:class:`LadderShedError`) or route
        it to the plan's registered cheaper variant, and its weight sets
        the fair share of batch slots the request competes under.  Frames
        stay where they are until their batch runs; ``compute()`` moves
        them to the plan's device."""
        with self._lock:
            if self.closed:
                raise RuntimeError("AsyncPlanServer is closed; no further requests")
            entry = self._plans.get(plan_name)
            if entry is None:
                raise KeyError(f"unknown plan {plan_name!r}; registered: {sorted(self._plans)}")
            t = self._tenant(tenant)
            n_in = len(entry.plan.graph.inputs)
            if len(frame_inputs) != n_in:
                raise TypeError(
                    f"plan {plan_name!r} expects {n_in} inputs per frame, "
                    f"got {len(frame_inputs)}"
                )
            frames = tuple(torch.as_tensor(f) for f in frame_inputs)
            # shape/dtype gate: one malformed request fails HERE (its own
            # "handle"), never inside the macro-batch it would have joined
            if entry.input_spec is None:
                entry.input_spec = tuple((tuple(f.shape), f.dtype) for f in frames)
            else:
                for i, (f, (shape, dtype)) in enumerate(zip(frames, entry.input_spec)):
                    if tuple(f.shape) != shape or f.dtype != dtype:
                        self._bump(entry, "bad_frames")
                        raise FrameSpecError(
                            f"plan {plan_name!r} input {i}: frame is "
                            f"{tuple(f.shape)}/{f.dtype}, spec is {shape}/{dtype}"
                        )
            now = self._clock()
            self._admit_tenant(t, priority, now)
            # pin the runnable at admission: primary, or -- when the
            # tenant sits on the demote_plan rung and a ladder variant is
            # registered -- the cheaper variant
            runner = entry.primary
            if t.level >= LADDER_LEVELS.index("demote_plan") and entry.ladder_variant is not None:
                runner = entry.variants[entry.ladder_variant]
                self._bump(entry, "demoted_admissions")
                self._bump_tenant(t, "demoted_admissions")
            shed: Optional[RequestHandle] = None
            if len(entry.queue) >= self.max_queue:
                if self.overload == "reject":
                    self._bump(entry, "rejected")
                    raise QueueFullError(
                        f"plan {plan_name!r} queue full "
                        f"({len(entry.queue)}/{self.max_queue}); request rejected"
                    )
                # shed: evict whichever of queue + {incoming} would be
                # scheduled *last* (max (-priority, seq)); at equal-or-lower
                # priority the incoming request IS scheduled last
                victim = max(entry.queue, key=lambda h: (-h.priority, h._seq))
                if (-priority, entry.seq) >= (-victim.priority, victim._seq):
                    self._bump(entry, "shed")
                    raise QueueFullError(
                        f"plan {plan_name!r} queue full "
                        f"({len(entry.queue)}/{self.max_queue}) of equal-or-"
                        f"higher-priority requests; new request shed"
                    )
                entry.queue.remove(victim)
                victim._inputs = None  # evicted: release its frames
                if victim._runner is not None:
                    victim._runner.outstanding -= 1
                    self._maybe_retire(entry)
                self._bump(entry, "shed")
                shed = victim
            handle = RequestHandle(
                rid=self._rid, plan=plan_name, priority=priority, tenant=t.name,
                deadline_at=None if deadline is None else now + deadline,
                submitted_at=now,
            )
            self._rid += 1
            handle._inputs = frames
            handle._seq = entry.seq
            entry.seq += 1
            handle._runner = runner
            runner.admitted += 1
            runner.outstanding += 1
            entry.queue.append(handle)
            self._bump(entry, "submitted")
            self._bump_tenant(t, "submitted")
            if len(entry.queue) > entry.queue_peak:
                entry.queue_peak = len(entry.queue)
                _metrics.registry().gauge(
                    "serving_queue_depth_peak", plan=plan_name
                ).set_max(entry.queue_peak)
            if _otrace.enabled():
                _otrace.async_begin("request", handle.rid, cat="serving", plan=plan_name,
                                    priority=priority, tenant=t.name)
        if shed is not None:
            shed._fail(QueueFullError(f"request {shed.rid} shed from full {plan_name!r} queue"),
                       now)
            if _otrace.enabled():
                _otrace.async_end("request", shed.rid, cat="serving", phase="shed")
        self._work.set()
        return handle

    def submit_llm(
        self,
        name: str,
        prompt_tokens,
        *,
        max_new_tokens: int = 16,
        eos_id: Optional[int] = None,
        priority: int = 0,
        deadline: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> SequenceHandle:
        """Queue one prompt for greedy generation on LLM ``name`` and return
        its :class:`SequenceHandle` immediately.  Tenancy composes as for
        :meth:`submit` (the token bucket gates admission, the ladder's shed
        rung turns away low-priority prompts); overload is reject-only: a
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
            t = self._tenant(tenant)
            cache = entry.cache
            if cache.pages_for(len(prompt) + 1) > cache.num_pages:
                raise ValueError(
                    f"prompt of {len(prompt)} tokens can never fit the "
                    f"{cache.num_pages}x{cache.page_size}-token cache"
                )
            now = self._clock()
            self._admit_tenant(t, priority, now)
            depth = len(entry.waiting) + len(entry.active)
            if depth >= self.max_queue:
                self._bump(entry, "rejected")
                raise QueueFullError(
                    f"llm {name!r} queue full ({depth}/{self.max_queue}); sequence rejected"
                )
            handle = SequenceHandle(
                rid=self._rid, plan=name, priority=priority, tenant=t.name,
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
            self._bump_tenant(t, "submitted")
            if depth + 1 > entry.queue_peak:
                entry.queue_peak = depth + 1
                _metrics.registry().gauge(
                    "serving_queue_depth_peak", plan=name
                ).set_max(entry.queue_peak)
            if _otrace.enabled():
                _otrace.async_begin("request", handle.rid, cat="serving", plan=name,
                                    priority=priority, tenant=t.name, kind="sequence")
        self._work.set()
        return handle

    def pending(self, plan_name: Optional[str] = None) -> int:
        with self._lock:
            if plan_name is not None:
                if plan_name in self._llms:
                    e = self._llms[plan_name]
                    return len(e.waiting) + len(e.active)
                return len(self._plans[plan_name].queue)
            return sum(len(e.queue) for e in self._plans.values()) + sum(
                len(e.waiting) + len(e.active) for e in self._llms.values()
            )

    # -- scheduling ---------------------------------------------------------- #
    def _ready(self, entry: _PlanEntry, now: float, force: bool) -> Optional[str]:
        """Why this queue should release a batch now (None = keep filling).
        Fill is judged per runnable (a batch serves exactly one PlanVersion);
        a tenant on the ``shrink_flush`` rung has its requests' flush_after
        scaled down by the ladder's shrink factor."""
        if not entry.queue:
            return None
        fill: Dict[int, int] = {}
        for h in entry.queue:
            r = h._runner
            n = fill.get(id(r), 0) + 1
            if n >= r.batch_size:
                return "full"
            fill[id(r)] = n
        if force:
            return "force"
        if self.flush_after is not None:
            for h in entry.queue:
                t = self._tenants.get(h.tenant)
                fa = self.flush_after
                if t is not None and t.level >= LADDER_LEVELS.index("shrink_flush"):
                    fa *= t.ladder.shrink_factor
                if now - h.submitted_at >= fa:
                    return "flush_after"
        margin = self.deadline_margin
        if any(h.deadline_at is not None and h.deadline_at - now <= margin for h in entry.queue):
            return "deadline"
        return None

    def _take_batch(self, entry: _PlanEntry, now: float) -> Tuple[List[RequestHandle], PlanVersion]:
        """Pop up to one runnable's batch_size requests and return
        ``(batch, runner)``.  The target runner is whichever PlanVersion the
        most urgent request (due deadline, then -priority, then arrival) is
        pinned to.  Within it, *due* requests join first (deadline urgency
        outranks priority class for batch membership), then the remaining
        slots are filled by weighted deficit round-robin across tenant
        sub-queues, each in ``(-priority, arrival)`` order."""
        margin = self.deadline_margin

        def key(h: RequestHandle):
            due = h.deadline_at is not None and h.deadline_at - now <= margin
            return (not due, -h.priority, h._seq)

        runner = min(entry.queue, key=key)._runner
        pool = [h for h in entry.queue if h._runner is runner]
        size = runner.batch_size
        batch = sorted(
            (h for h in pool if h.deadline_at is not None and h.deadline_at - now <= margin),
            key=lambda h: (-h.priority, h._seq),
        )[:size]
        taken = set(id(h) for h in batch)
        slots = size - len(batch)
        if slots > 0:
            by_tenant: Dict[str, List[RequestHandle]] = {}
            for h in pool:
                if id(h) not in taken:
                    by_tenant.setdefault(h.tenant, []).append(h)
            for q in by_tenant.values():
                q.sort(key=lambda h: (-h.priority, h._seq))
            weights = {n: self._tenants[n].weight for n in by_tenant if n in self._tenants}
            batch.extend(entry.drr.select(by_tenant, weights, slots))
            taken = set(id(h) for h in batch)
        entry.queue = [h for h in entry.queue if id(h) not in taken]
        return batch, runner

    def _execute(
        self, entry: _PlanEntry, runner: PlanVersion,
        batch: List[RequestHandle], reason: str = "full",
    ) -> None:
        """Run one macro-batch through the runner's chunk and resolve every
        handle.  Called with the admission lock *released* so submits keep
        landing while the device works.

        ``compute()`` moves the frames to the plan's device, runs the chunk
        and waits on a CUDA event recorded after it, so the verdict (and the
        completion time) comes when the kernels are done.  With a
        ``watchdog`` deadline it runs in a disposable daemon thread: if no
        verdict lands within the deadline the batch's handles fail with
        :class:`WatchdogTimeout` and the thread is abandoned (first verdict
        wins, so a late finish is harmless; its kernels, which cannot be
        cancelled, stay queued ahead of later batches)."""
        box: Dict[str, Any] = {}
        device = runner.plan.device

        def compute() -> None:
            try:
                # stacking stays inside the guard: a failing frame must fail
                # its batch's handles, never kill the scheduler thread
                inputs = tuple(
                    torch.stack([h._inputs[i].to(device) for h in batch])
                    for i in range(len(batch[0]._inputs))
                )
                out = runner.batched.run_chunk(runner.params, *inputs)
                _wait_for_device(device)
                box["out"] = out
            except Exception as e:  # resolve handles; callers see the error
                box["err"] = e

        bid = self._next_batch_id()
        with _otrace.span(
            "batch", cat="serving", plan=entry.name, batch=bid, reason=reason,
            version=runner.label(), rids=[h.rid for h in batch],
        ) as bsp:
            if _otrace.enabled():
                for h in batch:
                    _otrace.async_instant("request", h.rid, cat="serving", phase="batched",
                                          batch=bid)
            timed_out = False
            if self.watchdog is None:
                compute()
            else:
                worker = threading.Thread(target=compute, name=f"batch-{entry.name}",
                                          daemon=True)
                worker.start()
                worker.join(self.watchdog)
                timed_out = worker.is_alive()
            now = self._clock()
            with self._lock:
                out = box.get("out")
                err = box.get("err")
                if timed_out:
                    out = None
                    err = WatchdogTimeout(
                        f"batch of {len(batch)} on plan {entry.name!r} "
                        f"exceeded the {self.watchdog}s watchdog deadline"
                    )
                    self._bump(entry, "watchdog_timeouts")
                    bsp.set("timed_out", True)
                    _otrace.instant("watchdog_timeout", cat="serving", plan=entry.name,
                                    batch=bid)
                traced = _otrace.enabled()
                for i, h in enumerate(batch):
                    h._inputs = None  # executed: release the frames
                    if err is not None:
                        h._fail(err, now)
                    else:
                        h._resolve(tuple(o[i] for o in out) if isinstance(out, tuple)
                                   else out[i], now)
                    t = self._tenants.get(h.tenant)
                    if h.deadline_missed:
                        self._bump(entry, "deadline_misses")
                        if t is not None:
                            self._bump_tenant(t, "deadline_misses")
                        _otrace.instant("deadline_miss", cat="serving", plan=entry.name,
                                        rid=h.rid, batch=bid)
                    self._bump(entry, "completed")
                    if t is not None:
                        self._bump_tenant(t, "completed")
                    if h.latency is not None:
                        entry.latencies.append(h.latency)
                        _metrics.registry().histogram(
                            "serving_latency_seconds", plan=entry.name).observe(h.latency)
                        if t is not None:
                            t.observe(h.latency, h.deadline_missed)
                            _metrics.registry().histogram(
                                "serving_tenant_latency_seconds", tenant=t.name
                            ).observe(h.latency)
                    self._completed.append(h)
                    if traced:
                        _otrace.async_end(
                            "request", h.rid, cat="serving",
                            phase="failed" if err is not None else "completed",
                            batch=bid, deadline_missed=h.deadline_missed,
                        )
                self._bump(entry, "batches")
                self._bump(entry, "padded_frames", runner.batch_size - len(batch))
                runner.outstanding -= len(batch)
                self._maybe_retire(entry)
                self._inflight -= 1
                self._idle.notify_all()

    def step(self, *, force: bool = False) -> int:
        """One synchronous scheduler tick: visit every plan queue in fair
        rotation and execute at most ONE macro-batch per ready queue, then
        one prefill batch and one decode step per LLM.  Returns the number
        of batches executed.  ``force=True`` releases every non-empty queue
        regardless of fill or deadlines (the drain path of :meth:`close`).
        Time comes from the clock injected at construction only."""
        executed = 0
        with self._lock:
            self._evaluate_slos(self._clock())
            names = list(self._plans)
            if names:
                k = self._rr % len(names)
                rotation = names[k:] + names[:k]
                self._rr += 1
            else:
                rotation = []
        for name in rotation:
            with self._lock:
                entry = self._plans[name]
                t = self._clock()
                reason = self._ready(entry, t, force)
                if reason is None:
                    continue
                batch, runner = self._take_batch(entry, t)
                if reason in ("flush_after", "deadline"):
                    self._bump(entry, "deadline_flushes")
                self._inflight += 1
            self._execute(entry, runner, batch, reason)
            executed += 1
        for name in list(self._llms):
            executed += self._llm_tick(name)
        return executed

    def _evaluate_slos(self, now: float) -> None:
        """Walk every tenant's SLO ladder (call with the lock held).  Each
        tenant is judged at most once per ``ladder.interval`` of engine
        clock; a transition moves the ``serving_ladder_level`` gauge, counts
        into ``serving_ladder_transitions_total{tenant, direction,
        to_level}`` and emits a trace instant."""
        for t in self._tenants.values():
            if t.slo is None:
                continue
            if t.next_eval is None:
                t.next_eval = now + t.ladder.interval
                continue
            if now < t.next_eval:
                continue
            t.next_eval = now + t.ladder.interval
            moved = t.evaluate()
            if moved is None:
                continue
            frm, to = moved
            direction = "up" if to > frm else "down"
            _metrics.registry().gauge("serving_ladder_level", tenant=t.name).set(to)
            _metrics.registry().counter(
                "serving_ladder_transitions_total", tenant=t.name, direction=direction,
                to_level=LADDER_LEVELS[to],
            ).inc()
            _otrace.instant(f"ladder_{direction}", cat="serving", tenant=t.name,
                            from_level=LADDER_LEVELS[frm], to_level=LADDER_LEVELS[to])

    # -- autoregressive (LLM) scheduling -------------------------------------- #
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
            t = self._tenants.get(h.tenant)
            if t is not None:
                self._bump_tenant(t, "completed")
            if h.deadline_missed:
                self._bump(entry, "deadline_misses")
                if t is not None:
                    self._bump_tenant(t, "deadline_misses")
            if h.latency is not None:
                entry.latencies.append(h.latency)
                _metrics.registry().histogram(
                    "serving_latency_seconds", plan=entry.name
                ).observe(h.latency)
                if t is not None:
                    t.observe(h.latency, h.deadline_missed)
            self._completed.append(h)
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
        t = self._tenants.get(h.tenant)
        if t is not None:
            self._bump_tenant(t, "completed")
        self._completed.append(h)
        if _otrace.enabled():
            _otrace.async_end("request", h.rid, cat="serving", phase="failed")

    # -- background thread --------------------------------------------------- #
    def start(self) -> "AsyncPlanServer":
        """Launch the scheduler thread (idempotent).  It ticks whenever work
        arrives and at least every ``tick_interval`` seconds, so deadline
        releases fire even when no submits are landing."""
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
            except Exception:  # a bad tick is counted, never fatal
                with self._lock:
                    self._tick_errors += 1
                executed = 0
            if executed == 0:
                self._work.wait(self.tick_interval)
                self._work.clear()

    # -- completion / teardown ----------------------------------------------- #
    def drain_completed(self) -> List[RequestHandle]:
        """Hand over (and clear) the handles completed since the last drain,
        in completion order.  The buffer keeps only the most recent
        ``RETAINED_COMPLETIONS`` handles (results live on the handles
        either way)."""
        with self._lock:
            done = list(self._completed)
            self._completed.clear()
        return done

    def close(self) -> int:
        """Stop the scheduler thread, drain every queue (partial batches
        force-flush, sequences run to their end -- nothing accepted is
        dropped), and refuse further submits.  In-flight batches complete
        before close returns.  Returns the number of requests drained by
        close itself.  Idempotent; also runs on ``with`` exit."""
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
        drained = 0
        llm_drained = set()
        while True:  # synchronous force-drain of whatever is still queued
            with self._lock:
                queued = sum(len(e.queue) for e in self._plans.values())
                for e in self._llms.values():
                    for h in list(e.waiting) + list(e.active):
                        if id(h) not in llm_drained:
                            llm_drained.add(id(h))
                            queued += 1
            if queued == 0:
                break
            drained += queued
            while self.step(force=True):
                pass
        with self._lock:  # wait out any batch the thread left in flight
            while self._inflight:
                self._idle.wait()
        return drained

    def __enter__(self) -> "AsyncPlanServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- stats ---------------------------------------------------------------- #
    @property
    def stats(self) -> Dict[str, Any]:
        """Aggregate counters plus ``per_plan`` / ``per_tenant`` (and, with
        LLMs registered, ``per_llm``) breakdowns (copies).  The aggregate
        sums the per-plan counters only -- tenant counters are a second axis
        over the same requests, not additional traffic."""
        with self._lock:
            per_plan = {n: dict(e.stats) for n, e in self._plans.items()}
            per_tenant = {n: dict(t.stats) for n, t in self._tenants.items()}
            per_llm = {n: dict(e.stats) for n, e in self._llms.items()}
        total: Dict[str, Any] = {}
        for s in per_plan.values():
            for k, v in s.items():
                total[k] = total.get(k, 0) + v
        total["per_plan"] = per_plan
        total["per_tenant"] = per_tenant
        if per_llm:
            total["per_llm"] = per_llm
        return total

    def health(self) -> Dict[str, Any]:
        """One liveness/degradation snapshot: scheduler state (running,
        in-flight batches, survived tick errors), per-plan queue depths and
        counters (bad frames, watchdog timeouts, overload), and -- for
        guarded plans -- the executor's guard stats (demotion counters plus
        every circuit breaker's state).  This is what ``launch/serve.py
        --async`` prints."""
        with self._lock:
            plans: Dict[str, Any] = {}
            for n, e in self._plans.items():
                d: Dict[str, Any] = {
                    "queue_depth": len(e.queue),
                    "queue_peak": e.queue_peak,
                    "version": e.primary.version,
                    "stats": dict(e.stats),
                }
                if e.draining:
                    d["draining"] = [
                        {"version": v.version, "outstanding": v.outstanding} for v in e.draining
                    ]
                if e.variants:
                    d["variants"] = version_health(e.variants)
                    d["ladder_variant"] = e.ladder_variant
                gs = e.plan.guard_stats()
                if gs:
                    d["guard"] = gs
                plans[n] = d
            llms: Dict[str, Any] = {}
            for n, e in self._llms.items():
                ld: Dict[str, Any] = {
                    "waiting": len(e.waiting),
                    "active": len(e.active),
                    "queue_peak": e.queue_peak,
                    "cache": e.cache.occupancy(),
                    "stats": dict(e.stats),
                }
                for phase, p in (("prefill", e.prefill), ("decode", e.decode)):
                    gs = p.guard_stats()
                    if gs:
                        ld.setdefault("guard", {})[phase] = gs
                llms[n] = ld
            tenants = {
                n: {
                    "level": t.level,
                    "level_name": t.level_name,
                    "weight": t.weight,
                    "tokens": t.bucket.tokens,
                    "stats": dict(t.stats),
                }
                for n, t in self._tenants.items()
            }
            out = {
                "closed": self.closed,
                "running": self.running,
                "inflight": self._inflight,
                "tick_errors": self._tick_errors,
                "watchdog": self.watchdog,
                "pending": sum(p["queue_depth"] for p in plans.values())
                + sum(v["waiting"] + v["active"] for v in llms.values()),
                "plans": plans,
                "tenants": tenants,
            }
            if llms:
                out["llms"] = llms
            return out

    def latency_stats(self, plan_name: Optional[str] = None) -> Dict[str, float]:
        """p50/p95/p99/mean completion latency (seconds) over the completed
        requests of one plan or LLM (or all of them)."""
        with self._lock:
            if plan_name is not None:
                src = self._llms[plan_name] if plan_name in self._llms else self._plans[plan_name]
                lats: Sequence[float] = list(src.latencies)
            else:
                lats = [v for e in list(self._plans.values()) + list(self._llms.values())
                        for v in e.latencies]
        if not lats:
            return {"count": 0, "p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0}
        arr = np.asarray(lats)
        return {
            "count": int(arr.size),
            "p50": float(np.percentile(arr, 50)),
            "p95": float(np.percentile(arr, 95)),
            "p99": float(np.percentile(arr, 99)),
            "mean": float(arr.mean()),
        }


def submit_with_retry(
    server: AsyncPlanServer,
    plan_name: str,
    *frame_inputs,
    priority: int = 0,
    deadline: Optional[float] = None,
    tenant: Optional[str] = None,
    retries: int = 5,
    backoff: float = 0.005,
    backoff_factor: float = 2.0,
    jitter: float = 0.5,
    sleep: Callable[[float], None] = time.sleep,
) -> RequestHandle:
    """``server.submit`` wrapped in jittered exponential backoff on
    :class:`QueueFullError` -- the client-side companion to the bounded
    admission queue.  Only ``QueueFullError`` retries (which includes its
    transient subclasses :class:`QuotaExceededError` and
    :class:`LadderShedError`); ``FrameSpecError`` and closed-server errors
    are permanent, and a queue that stays full through every retry still
    raises."""
    return retry_call(
        lambda: server.submit(plan_name, *frame_inputs, priority=priority, deadline=deadline,
                              tenant=tenant),
        retries=retries, backoff=backoff, backoff_factor=backoff_factor,
        jitter=jitter, retry_on=(QueueFullError,), sleep=sleep,
    )
