"""Serving for the port: the plan server (``PlanServer``), the paged
KV-cache, ``AsyncPlanServer`` (frame plans with tenants, hot swap and the
watchdog; prefill / decode plan pairs through ``submit_llm``), tenancy and
rollout -- what ``repro.serving`` exports, the LM ``Engine`` /
``RequestScheduler`` aside."""

from .engine import PlanServer
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
    "FrameSpecError",
    "LADDER_LEVELS",
    "LadderConfig",
    "LadderShedError",
    "PagedKVCache",
    "PlanServer",
    "PlanVersion",
    "QueueFullError",
    "QuotaExceededError",
    "RequestHandle",
    "SequenceHandle",
    "SwapError",
    "Tenant",
    "TenantSLO",
    "TokenBucket",
    "WatchdogTimeout",
    "submit_with_retry",
]
