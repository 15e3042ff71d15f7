"""Observability for the port: the metrics registry and structured tracing
(copies of ``repro.obs.metrics`` / ``repro.obs.trace``)."""

from . import metrics, trace
from .metrics import MetricsRegistry, registry

__all__ = ["metrics", "trace", "MetricsRegistry", "registry"]
