"""Serving for the port: the plan server (``PlanServer``), the paged
KV-cache and the LLM half of ``AsyncPlanServer`` (``add_llm`` /
``submit_llm``)."""

from .engine import PlanServer
from .kvcache import CacheFullError, PagedKVCache
from .scheduler import AsyncPlanServer, QueueFullError, RequestHandle, SequenceHandle

__all__ = [
    "AsyncPlanServer",
    "CacheFullError",
    "PagedKVCache",
    "PlanServer",
    "QueueFullError",
    "RequestHandle",
    "SequenceHandle",
]
