"""Fault tolerance for long training runs (a copy of the JAX package's
``training/fault_tolerance.py``; stdlib only).

* :class:`PreemptionHandler` -- SIGTERM/SIGINT turn into a flag the train
  loop polls; the loop checkpoints and exits cleanly instead of dying
  mid-step (maps to Borg/GKE preemption notices and TPU maintenance events).
* :func:`retry` -- exponential-backoff wrapper for transient infrastructure
  errors (checkpoint FS hiccups, collective timeouts surfaced as XlaRuntime
  errors at real scale).
* :class:`StragglerMonitor` -- per-step wall-time tracker; steps slower than
  ``threshold x`` running median raise a hook (at scale: trigger hot-spare
  swap / re-shard; here: logged + counted, and the hook is injectable so the
  launcher can act).
* :class:`Heartbeat` -- background thread touching a file every interval;
  an external watchdog restarting dead workers is the standard companion.
"""

from __future__ import annotations

import os
import signal
import statistics
import threading
import time
from typing import Any, Callable, List, Optional

from ..utils.retry import retry_call

__all__ = ["PreemptionHandler", "retry", "retry_call", "StragglerMonitor", "Heartbeat"]


class PreemptionHandler:
    """Context manager installing signal handlers that set ``should_stop``."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._previous = {}
        self.should_stop = False
        self.received: Optional[int] = None

    def _handler(self, signum, frame):
        self.should_stop = True
        self.received = signum

    def __enter__(self) -> "PreemptionHandler":
        for s in self._signals:
            self._previous[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)


def retry(
    fn: Callable[[], Any],
    *,
    retries: int = 3,
    backoff: float = 1.0,
    backoff_factor: float = 2.0,
    retry_on: tuple = (OSError, IOError, RuntimeError),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> Any:
    """Run ``fn`` with exponential backoff on transient errors.

    The implementation lives in :func:`..utils.retry.retry_call` (which
    adds jitter and injectable sleep/rng); this keeps the original
    signature and behavior."""
    return retry_call(
        fn, retries=retries, backoff=backoff, backoff_factor=backoff_factor,
        retry_on=retry_on, on_retry=on_retry,
    )


class StragglerMonitor:
    """Detects slow steps against a running median.

    At 1000+ node scale the same signal (per-host step time, collected via
    the coordination service) drives hot-spare replacement; the ``on_straggler``
    hook is where that action plugs in.
    """

    def __init__(
        self,
        threshold: float = 2.0,
        window: int = 50,
        on_straggler: Optional[Callable[[int, float, float], None]] = None,
    ):
        self.threshold = threshold
        self.window = window
        self.on_straggler = on_straggler
        self.times: List[float] = []
        self.straggler_steps: List[int] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start_step(self) -> None:
        self._t0 = time.monotonic()

    def end_step(self) -> Optional[float]:
        if self._t0 is None:
            return None
        dt = time.monotonic() - self._t0
        self._t0 = None
        self._step += 1
        history = self.times[-self.window :]
        if len(history) >= 5:
            med = statistics.median(history)
            # ignore noise around sub-100ms steps: absolute + relative gate
            if dt > self.threshold * med and dt - med > 0.1:
                self.straggler_steps.append(self._step)
                if self.on_straggler:
                    self.on_straggler(self._step, dt, med)
        self.times.append(dt)
        return dt

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0


class Heartbeat:
    """Touches ``path`` every ``interval`` seconds from a daemon thread."""

    def __init__(self, path: str, interval: float = 10.0):
        self.path = path
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.beat()

    def beat(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            f.write(str(time.time()))

    def __enter__(self) -> "Heartbeat":
        self.beat()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2 * self.interval)
