"""Shared retry-with-backoff helper (a copy of ``repro/utils/retry.py``).

The serving layer uses it for ``QueueFullError`` submit retries
(``serving.scheduler.submit_with_retry``).  Full jitter and injectable
sleep / rng let tests -- and the chaos phase -- drive the schedule
deterministically without wall-clock waits.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Optional, Tuple

__all__ = ["retry_call"]


def retry_call(
    fn: Callable[[], Any],
    *,
    retries: int = 3,
    backoff: float = 1.0,
    backoff_factor: float = 2.0,
    jitter: float = 0.0,
    retry_on: Tuple[type, ...] = (OSError, IOError, RuntimeError),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
) -> Any:
    """Run ``fn`` with exponential backoff on transient errors.

    Attempt ``i``'s failure sleeps ``backoff * backoff_factor**i`` seconds,
    stretched by up to ``jitter`` fraction (``delay * (1 + jitter * U[0,1))``)
    to decorrelate retry storms across concurrent callers.  The final
    failure re-raises.  ``on_retry(attempt, exc)`` observes every retried
    failure (attempt is 0-based)."""
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    if jitter < 0:
        raise ValueError(f"jitter must be >= 0, got {jitter}")
    rng = rng or random
    delay = backoff
    for attempt in range(retries + 1):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203
            if attempt == retries:
                raise
            if on_retry:
                on_retry(attempt, e)
            sleep(delay * (1.0 + jitter * rng.random()))
            delay *= backoff_factor
