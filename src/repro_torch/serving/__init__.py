"""Serving for the port -- what ``repro.serving`` exports: the LM ``Engine``
and its slot-based ``RequestScheduler``, the plan server (``PlanServer``),
the paged KV-cache, ``AsyncPlanServer`` (frame plans with tenants, hot swap
and the watchdog; prefill / decode plan pairs through ``submit_llm``),
tenancy and rollout."""

from .engine import Engine, GenerationResult, PlanServer, Request, RequestScheduler
from .kvcache import CacheFullError, PagedKVCache
from .rollout import PlanVersion, SwapError
from .scheduler import (
    AsyncPlanServer,
    FrameSpecError,
    LadderShedError,
    QueueFullError,
    QuotaExceededError,
    RequestHandle,
    SequenceHandle,
    WatchdogTimeout,
    submit_with_retry,
)
from .tenancy import (
    LADDER_LEVELS,
    DeficitRoundRobin,
    LadderConfig,
    Tenant,
    TenantSLO,
    TokenBucket,
)

__all__ = [
    "AsyncPlanServer",
    "CacheFullError",
    "DeficitRoundRobin",
    "Engine",
    "FrameSpecError",
    "GenerationResult",
    "LADDER_LEVELS",
    "LadderConfig",
    "LadderShedError",
    "PagedKVCache",
    "PlanServer",
    "PlanVersion",
    "QueueFullError",
    "QuotaExceededError",
    "Request",
    "RequestHandle",
    "RequestScheduler",
    "SequenceHandle",
    "SwapError",
    "Tenant",
    "TenantSLO",
    "TokenBucket",
    "WatchdogTimeout",
    "submit_with_retry",
]
