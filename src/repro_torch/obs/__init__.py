"""Observability for the port (the exports of ``repro.obs``):

* :mod:`repro_torch.obs.metrics` -- process-wide named counters / gauges /
  bounded-reservoir histograms with labels, JSON + Prometheus exporters;
* :mod:`repro_torch.obs.trace` -- nestable spans with an injectable clock,
  Chrome-trace / Perfetto JSON output, near-zero cost when disabled;
* :mod:`repro_torch.obs.profile` -- ``profile_plan``: run a compiled plan
  under tracing and reduce it to a per-step table of host ms, device ms (on
  the card), bytes and attribution.
"""

from . import metrics, trace
from .metrics import MetricsRegistry, registry
from .profile import PlanProfile, StepProfile, profile_plan
from .trace import (
    TraceBuffer,
    async_begin,
    async_end,
    async_instant,
    current_buffer,
    instant,
    span,
    start_tracing,
    stop_tracing,
    tracing,
)

__all__ = [
    "metrics",
    "trace",
    "MetricsRegistry",
    "registry",
    "PlanProfile",
    "StepProfile",
    "profile_plan",
    "TraceBuffer",
    "span",
    "instant",
    "async_begin",
    "async_instant",
    "async_end",
    "start_tracing",
    "stop_tracing",
    "tracing",
    "current_buffer",
]
