"""Per-key circuit breakers + the guarded-execution config (a copy of
``repro/robustness/breaker.py``).

The ``guarded`` executor backend (``core/graph/executor.py``) demotes a
failing kernel step to its plain-torch ``reference`` handler.  A breaker sits in
front of every demotable ``(op, scheme)`` family of a plan so that a
*persistently* failing kernel stops being retried request after request:

::

    closed --[>= threshold failures within window]--> open
    open   --[cooldown elapsed]--> half_open (one probe allowed)
    half_open --[probe succeeds]--> closed
    half_open --[probe fails]-----> open (cooldown restarts)

While ``open``, :meth:`CircuitBreaker.allow` returns ``False`` and the
executor short-circuits straight to the reference handler -- no kernel
attempt, no exception churn.  The clock is injectable so tests (and the
chaos suite) can drive the cooldown deterministically.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict

__all__ = ["BreakerOpen", "CircuitBreaker", "GuardConfig", "NumericGuardError"]


class NumericGuardError(RuntimeError):
    """Raised (and caught) by the guarded executor when a kernel step
    produced NaN/Inf output -- treated exactly like a kernel exception:
    the step demotes to reference and the breaker records a failure."""


class BreakerOpen(RuntimeError):
    """Raised by :meth:`CircuitBreaker.raise_if_open` for callers that
    want open-breaker short-circuits to be an exception, not a branch."""


class CircuitBreaker:
    """closed -> open -> half_open state machine over a failure window."""

    def __init__(
        self,
        threshold: int = 3,
        window: float = 30.0,
        cooldown: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.window = window
        self.cooldown = cooldown
        self.clock = clock
        self.state = "closed"
        self.trips = 0  # closed/half_open -> open transitions
        self.opened_at: float | None = None
        self._failures: Deque[float] = deque()

    def allow(self) -> bool:
        """May the caller attempt the primary path right now?  An open
        breaker whose cooldown has elapsed moves to ``half_open`` and
        allows exactly the probe attempt(s) until a verdict lands."""
        if self.state == "closed" or self.state == "half_open":
            return True
        if self.clock() - self.opened_at >= self.cooldown:
            self.state = "half_open"
            return True
        return False

    def raise_if_open(self) -> None:
        if not self.allow():
            raise BreakerOpen(
                f"breaker open for {self.cooldown - (self.clock() - self.opened_at):.3f}s more"
            )

    def record_failure(self) -> None:
        now = self.clock()
        if self.state == "half_open":  # failed probe: back to open
            self.state = "open"
            self.opened_at = now
            self.trips += 1
            return
        self._failures.append(now)
        while self._failures and now - self._failures[0] > self.window:
            self._failures.popleft()
        if len(self._failures) >= self.threshold:
            self.state = "open"
            self.opened_at = now
            self.trips += 1
            self._failures.clear()

    def record_success(self) -> None:
        if self.state == "half_open":  # probe succeeded: recover
            self.state = "closed"
            self.opened_at = None
            self._failures.clear()

    def snapshot(self) -> Dict[str, Any]:
        return {
            "state": self.state,
            "trips": self.trips,
            "recent_failures": len(self._failures),
        }


@dataclasses.dataclass
class GuardConfig:
    """Knobs for the ``guarded`` executor backend.

    ``primary`` names the handler table tried first (``"quant"`` -- the
    kernel overlay including the INT8 handlers -- by default, so guarded
    plans execute both plain and quantized graphs); the fallback is always
    the ``reference`` table.  ``numeric_guards`` adds a post-step NaN/Inf
    check on concrete outputs (a poisoned output demotes like an
    exception).  The breaker fields configure one :class:`CircuitBreaker`
    per demotable ``(op, scheme)`` key of the plan."""

    primary: str = "quant"
    numeric_guards: bool = True
    breaker_threshold: int = 3
    breaker_window: float = 30.0
    breaker_cooldown: float = 5.0
    clock: Callable[[], float] = time.monotonic

    def make_breaker(self) -> CircuitBreaker:
        return CircuitBreaker(
            threshold=self.breaker_threshold,
            window=self.breaker_window,
            cooldown=self.breaker_cooldown,
            clock=self.clock,
        )
