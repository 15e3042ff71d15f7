"""Multi-tenant admission control: quotas, fair share, and the SLO ladder
(a copy of ``repro/serving/tenancy.py``: host logic on the server's clock).

One :class:`~repro_torch.serving.scheduler.AsyncPlanServer` process hosts every
demo app; this module makes it host every *customer* too.  Three pieces,
all deterministic (every time source is the server's injectable clock):

* :class:`TokenBucket` -- per-tenant admission quota.  ``rate`` tokens/s
  refill up to ``burst``; a submit that finds the bucket empty is
  *throttled* (``QuotaExceededError``, a transient ``QueueFullError``
  subclass, so ``submit_with_retry`` rides it out).  Quotas bound what a
  tenant may *offer*; fair share (below) bounds what it may *consume*.
* :class:`DeficitRoundRobin` -- weighted fair-share selection of batch
  members across tenant queues.  Each round a tenant's deficit grows by
  its weight and it may take one slot per whole unit of deficit, so over
  any backlogged window tenant ``i`` completes ``w_i / sum(w)`` of the
  slots (+/- one round's granularity) and **no tenant starves**: a
  positive weight earns a slot every ``ceil(1/w)`` rounds no matter how
  hot its neighbours run.  Deficits reset when a tenant's queue empties
  (idle tenants must not bank credit) and persist across batches
  otherwise.
* :class:`Tenant` + :class:`TenantSLO` + :class:`LadderConfig` -- the
  graceful-degradation ladder.  Each tenant's SLO (p99 latency and/or
  deadline-miss-rate targets) is evaluated from its *own* completion
  window every ``LadderConfig.interval`` seconds of engine clock; a
  breach streak escalates that tenant one rung, an in-SLO streak (longer:
  hysteresis) recovers one rung::

      0 normal        -> full service
      1 shrink_flush  -> the tenant's queued requests release partial
                         batches after flush_after * shrink_factor
                         (latency beats batching efficiency)
      2 demote_plan   -> the tenant's NEW admissions route to the plan's
                         registered cheaper variant (quantized / guarded
                         reference); in-flight work is untouched
      3 shed          -> the tenant's lowest-priority admissions are
                         turned away at submit (LadderShedError)

  Every transition is counted (``serving_ladder_transitions_total``),
  gauged (``serving_ladder_level``), traced as an instant, and visible in
  ``AsyncPlanServer.health()`` -- overload is absorbed by an explicit,
  observable policy instead of the watchdog.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple, TypeVar

import numpy as np

__all__ = [
    "DeficitRoundRobin",
    "LADDER_LEVELS",
    "LadderConfig",
    "Tenant",
    "TenantSLO",
    "TokenBucket",
]

#: rung names, indexed by ladder level
LADDER_LEVELS = ("normal", "shrink_flush", "demote_plan", "shed")

#: per-tenant latency reservoir (window observations between SLO evals)
TENANT_LATENCY_RESERVOIR = 4096


class TokenBucket:
    """Classic token bucket on an injectable clock.  ``rate`` tokens/s
    refill up to ``burst``; ``take(now)`` consumes one token or reports
    exhaustion.  ``rate=None`` means unlimited (every take succeeds)."""

    def __init__(self, rate: Optional[float], burst: Optional[float] = None):
        if rate is not None and rate <= 0:
            raise ValueError(f"quota rate must be > 0 tokens/s, got {rate}")
        self.rate = rate
        self.burst = float(burst if burst is not None else (rate or 0) * 1.0) \
            if rate is not None else None
        if rate is not None and self.burst < 1.0:
            # a burst below one token could never admit anything
            self.burst = 1.0
        self.tokens = self.burst
        self._last: Optional[float] = None

    def take(self, now: float) -> bool:
        """Consume one token (refilled to ``now``); False when exhausted."""
        if self.rate is None:
            return True
        if self._last is not None and now > self._last:
            self.tokens = min(self.burst, self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


@dataclasses.dataclass
class TenantSLO:
    """Per-tenant service-level objective, evaluated over the completions
    since the previous evaluation.  ``None`` targets are not checked; an
    evaluation with fewer than ``min_samples`` completions is skipped
    (streaks hold) so a quiet tenant neither escalates nor recovers on
    noise."""

    p99_latency: Optional[float] = None  # seconds
    max_miss_rate: Optional[float] = None  # deadline misses / completions
    min_samples: int = 8

    def breached(self, p99: float, miss_rate: float) -> bool:
        if self.p99_latency is not None and p99 > self.p99_latency:
            return True
        if self.max_miss_rate is not None and miss_rate > self.max_miss_rate:
            return True
        return False


@dataclasses.dataclass
class LadderConfig:
    """Degradation-ladder tuning.  Escalation needs ``breach_evals``
    consecutive breached evaluations; recovery needs ``recover_evals``
    consecutive in-SLO evaluations -- strictly more by default, so the
    ladder is hysteretic and cannot flap once per evaluation."""

    interval: float = 0.05  # engine-clock seconds between evaluations
    breach_evals: int = 2
    recover_evals: int = 4
    shrink_factor: float = 0.25  # rung-1 flush_after multiplier
    shed_below_priority: int = 1  # rung 3 sheds admissions with prio < this

    def __post_init__(self):
        if not 0 < self.shrink_factor <= 1:
            raise ValueError(
                f"shrink_factor must be in (0, 1], got {self.shrink_factor}"
            )
        if self.breach_evals < 1 or self.recover_evals < 1:
            raise ValueError("breach_evals/recover_evals must be >= 1")


@dataclasses.dataclass(eq=False)
class Tenant:
    """One tenant's admission/fair-share/SLO state inside a server.  All
    mutation happens under the owning server's lock."""

    name: str
    weight: float = 1.0
    bucket: TokenBucket = dataclasses.field(
        default_factory=lambda: TokenBucket(None)
    )
    slo: Optional[TenantSLO] = None
    ladder: LadderConfig = dataclasses.field(default_factory=LadderConfig)
    #: current rung (index into LADDER_LEVELS)
    level: int = 0
    breach_streak: int = 0
    ok_streak: int = 0
    #: engine-clock time of the next SLO evaluation (None until first tick)
    next_eval: Optional[float] = None
    #: completions / deadline misses since the last SLO evaluation
    window_completed: int = 0
    window_misses: int = 0
    window_latencies: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=TENANT_LATENCY_RESERVOIR)
    )
    stats: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {
            "submitted": 0, "completed": 0, "throttled": 0, "ladder_shed": 0,
            "demoted_admissions": 0, "deadline_misses": 0,
            "ladder_up": 0, "ladder_down": 0,
        }
    )

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, got {self.weight}"
            )

    @property
    def level_name(self) -> str:
        return LADDER_LEVELS[self.level]

    def observe(self, latency: float, missed: bool) -> None:
        """Record one completion into the current SLO window."""
        self.window_completed += 1
        self.window_misses += int(missed)
        self.window_latencies.append(latency)

    def evaluate(self) -> Optional[Tuple[int, int]]:
        """One SLO evaluation over the window since the last call.  Returns
        ``(from_level, to_level)`` when the ladder moved, else None.  The
        window resets whenever it was large enough to judge; undersized
        windows carry over (streaks hold)."""
        if self.slo is None:
            return None
        if self.window_completed < self.slo.min_samples:
            return None
        lats = np.asarray(self.window_latencies)
        p99 = float(np.percentile(lats, 99)) if lats.size else 0.0
        miss_rate = self.window_misses / self.window_completed
        breached = self.slo.breached(p99, miss_rate)
        self.window_completed = 0
        self.window_misses = 0
        self.window_latencies.clear()
        if breached:
            self.breach_streak += 1
            self.ok_streak = 0
            if (
                self.breach_streak >= self.ladder.breach_evals
                and self.level < len(LADDER_LEVELS) - 1
            ):
                self.breach_streak = 0
                frm, self.level = self.level, self.level + 1
                self.stats["ladder_up"] += 1
                return (frm, self.level)
        else:
            self.ok_streak += 1
            self.breach_streak = 0
            if self.ok_streak >= self.ladder.recover_evals and self.level > 0:
                self.ok_streak = 0
                frm, self.level = self.level, self.level - 1
                self.stats["ladder_down"] += 1
                return (frm, self.level)
        return None


T = TypeVar("T")


class DeficitRoundRobin:
    """Weighted deficit round-robin over named queues (one instance per
    plan queue).  ``select`` fills up to ``slots`` from per-tenant
    candidate lists: the rotation visits tenants in registration order
    starting one past last call's starting tenant, each visited tenant's
    deficit grows by its weight once per round, and every whole unit of
    deficit buys one slot.  Long-run share is weight-proportional with at
    most one round of slack; a tenant whose candidate list is empty has
    its deficit reset (no banking credit while idle)."""

    def __init__(self):
        self.deficits: Dict[str, float] = {}
        self._start = 0

    def select(
        self,
        candidates: Dict[str, List[T]],
        weights: Dict[str, float],
        slots: int,
    ) -> List[T]:
        """Destructively pop up to ``slots`` items across the candidate
        lists (each list already in that tenant's preferred order)."""
        out: List[T] = []
        names = list(candidates)
        if not names or slots <= 0:
            return out
        order = names[self._start % len(names):] + names[: self._start % len(names)]
        self._start += 1
        for name in names:
            if not candidates[name]:
                self.deficits[name] = 0.0
        while slots > 0 and any(candidates[n] for n in order):
            for name in order:
                q = candidates[name]
                if not q:
                    self.deficits[name] = 0.0
                    continue
                self.deficits[name] = self.deficits.get(name, 0.0) + weights.get(name, 1.0)
                while q and slots > 0 and self.deficits[name] >= 1.0:
                    out.append(q.pop(0))
                    self.deficits[name] -= 1.0
                    slots -= 1
                if slots == 0:
                    break
        return out

    def forget(self, names: Sequence[str]) -> None:
        for n in names:
            self.deficits.pop(n, None)
