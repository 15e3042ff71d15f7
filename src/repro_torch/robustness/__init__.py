"""Robustness of the port: circuit breakers, the guarded-execution config
and seeded fault injection (a port of ``repro.robustness``)."""

from .breaker import BreakerOpen, CircuitBreaker, GuardConfig, NumericGuardError
from .faults import (
    FaultPlan,
    FaultRule,
    InjectedFault,
    active_fault_plan,
    corrupt_tuning_cache,
    uninstall_all,
    wrap_handler,
)

__all__ = [
    "BreakerOpen",
    "CircuitBreaker",
    "FaultPlan",
    "FaultRule",
    "GuardConfig",
    "InjectedFault",
    "NumericGuardError",
    "active_fault_plan",
    "corrupt_tuning_cache",
    "uninstall_all",
    "wrap_handler",
]
