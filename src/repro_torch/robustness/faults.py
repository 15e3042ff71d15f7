"""Seeded, deterministic fault injection for chaos testing (a port of
``repro/robustness/faults.py``: the same sites, kinds and seeded draws).

A :class:`FaultPlan` is a registry of :class:`FaultRule`\\ s -- *where* to
inject (an fnmatch pattern over fault **sites**), *what* to inject, and at
what per-call rate.  Sites come in two flavors:

* **kernel entry points** -- the public wrappers in ``kernels/ops.py``
  (``matmul`` / ``qmatmul`` / ``conv2d`` / ``fused_elementwise``; the
  executor's handlers call them through the module, and ``col_matmul``
  reaches ``matmul`` through the module global).
  :meth:`FaultPlan.install` monkey-patches the module attributes, so every
  caller that resolves them at call time (the executor's kernel/quant
  handlers do) sees the faulty versions; :meth:`uninstall` restores the
  originals bit-for-bit.
* **op handler sites** -- node op names (``linear``, ``conv2d``,
  ``qlinear``, ...).  The ``guarded`` executor consults
  :func:`wrap_handler` before every primary attempt, so handler-site
  faults hit guarded plans regardless of when the plan was compiled.
  Reference handlers are never wrapped -- the fallback/oracle path stays
  clean by construction.

Fault kinds:

``raise``
    raise :class:`InjectedFault` *before* the real op runs (a crashing
    kernel).
``nan`` / ``inf``
    run the real op, then poison the output tensor on its device (a
    numerically broken kernel -- what the guarded backend's post-step
    numeric guards catch).
``latency``
    sleep ``delay`` seconds on the host, then run the real op (a hung
    build / straggler step -- what the serving watchdog catches).
``cache_corrupt``
    one-shot at :meth:`install`: overwrite a ``rate`` fraction of the
    process :class:`~repro_torch.kernels.ops.TuningCache` entries with
    degenerate block tuples (all-zero), so the next kernel call through
    those keys raises ``TileError`` before it launches -- corrupted-
    persistence chaos.

Determinism: every decision comes from one ``random.Random(seed)`` stream
(guarded by a lock), so a chaos run with a fixed seed and a fixed call
order injects the identical fault sequence.  Installed plans stack;
:func:`uninstall_all` force-restores everything (the conftest isolation
fixture calls it so a failing chaos test can never leak patched kernels
into the rest of the suite; the port's test files have a fixture of
their own that does the same).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from fnmatch import fnmatch
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..kernels import ops as kops

__all__ = [
    "FaultPlan",
    "FaultRule",
    "InjectedFault",
    "active_fault_plan",
    "corrupt_tuning_cache",
    "uninstall_all",
    "wrap_handler",
]

#: the ops-module attributes a plan may patch (the four kernel families'
#: public entry points; col_matmul reaches matmul through the module global,
#: so patching matmul covers it too)
ENTRY_POINTS = ("matmul", "qmatmul", "conv2d", "fused_elementwise")

KINDS = ("raise", "nan", "inf", "latency", "cache_corrupt")


class InjectedFault(RuntimeError):
    """The exception a ``raise``-kind rule throws at its site."""


@dataclasses.dataclass(frozen=True)
class FaultRule:
    site: str  # fnmatch pattern over fault sites ("matmul", "conv2d", "*")
    kind: str  # one of KINDS
    rate: float = 1.0  # per-call injection probability (fraction for cache_corrupt)
    delay: float = 0.05  # latency-kind sleep seconds
    message: str = "injected fault"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"fault kind {self.kind!r}: want one of {KINDS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")


#: stack of installed plans (last installed wins for overlapping sites --
#: each plan's wrappers nest)
_ACTIVE: List["FaultPlan"] = []


def active_fault_plan() -> Optional["FaultPlan"]:
    """The most recently installed plan (None when chaos is off)."""
    return _ACTIVE[-1] if _ACTIVE else None


def wrap_handler(site: str, fn: Callable) -> Callable:
    """Wrap an op handler with every active plan's injection at ``site``
    (identity when no plan is installed or no rule matches) -- the guarded
    executor's per-step hook."""
    for plan in _ACTIVE:
        fn = plan.wrap(site, fn)
    return fn


def uninstall_all() -> int:
    """Force-restore every installed plan (teardown safety net)."""
    n = 0
    while _ACTIVE:
        _ACTIVE[-1].uninstall()
        n += 1
    return n


def corrupt_tuning_cache(rng, fraction: float = 1.0) -> List[str]:
    """Overwrite a deterministic ``fraction`` of the process TuningCache's
    entries with degenerate all-zero block tuples (same arity, so legacy
    normalization keeps them) -- the next kernel call that resolves one
    raises ``TileError`` on the zero tile before it launches, which is
    exactly what the guarded executor must absorb.  Returns the corrupted
    keys."""
    cache = kops.tuning_cache()
    keys = sorted(cache.entries)
    corrupted = []
    for k in keys:
        if rng.random() < fraction:
            e = cache.entries[k]
            cache.entries[k] = kops.TuneEntry(
                tuple(0 for _ in e.blocks), "corrupt", None
            )
            corrupted.append(k)
    return corrupted


class FaultPlan:
    """A seeded registry of fault rules, installable over the kernel entry
    points (and consulted per-step by the guarded executor).  Use as a
    context manager so a failing test can never leak the patches::

        with FaultPlan([FaultRule("matmul", "raise", rate=0.05)], seed=0):
            ...  # 5% of matmul calls raise InjectedFault, deterministically
    """

    def __init__(
        self,
        rules: Sequence[FaultRule],
        *,
        seed: int = 0,
        entry_points: Sequence[str] = ENTRY_POINTS,
        sleep: Callable[[float], None] = time.sleep,
    ):
        import random

        self.rules = tuple(rules)
        self.seed = seed
        self.entry_points = tuple(entry_points)
        self.sleep = sleep
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._originals: Dict[str, Callable] = {}
        #: site -> kind -> injections actually fired
        self.injected: Dict[str, Dict[str, int]] = {}
        #: site -> calls observed (fired or not): rate denominators
        self.calls: Dict[str, int] = {}
        self.corrupted_keys: Tuple[str, ...] = ()

    # -- bookkeeping --------------------------------------------------------- #
    def injection_count(self, site: Optional[str] = None) -> int:
        with self._lock:
            sites = [site] if site is not None else list(self.injected)
            return sum(
                sum(self.injected.get(s, {}).values()) for s in sites
            )

    # -- decision + effects -------------------------------------------------- #
    def _fire(self, site: str):
        """Roll the dice for ``site``.  Raises for ``raise`` rules, sleeps
        for ``latency`` rules, and returns a post-processor (or None) for
        poisoning rules.  First matching rule wins."""
        with self._lock:
            self.calls[site] = self.calls.get(site, 0) + 1
            rule = None
            for r in self.rules:
                if r.kind != "cache_corrupt" and fnmatch(site, r.site):
                    if self._rng.random() < r.rate:
                        rule = r
                    break  # first matching rule owns the site
            if rule is not None:
                by_kind = self.injected.setdefault(site, {})
                by_kind[rule.kind] = by_kind.get(rule.kind, 0) + 1
        if rule is None:
            return None
        if rule.kind == "raise":
            raise InjectedFault(f"{site}: {rule.message}")
        if rule.kind == "latency":
            self.sleep(rule.delay)
            return None
        poison = float("nan") if rule.kind == "nan" else float("inf")
        return lambda y: torch.full_like(y, poison)

    def wrap(self, site: str, fn: Callable) -> Callable:
        """``fn`` with this plan's injection at ``site`` (identity when no
        non-corrupt rule matches the site)."""
        if not any(
            r.kind != "cache_corrupt" and fnmatch(site, r.site)
            for r in self.rules
        ):
            return fn

        def faulty(*args, **kwargs):
            post = self._fire(site)
            y = fn(*args, **kwargs)
            return post(y) if post is not None else y

        faulty.__wrapped__ = fn
        faulty.__name__ = f"faulty_{getattr(fn, '__name__', site)}"
        return faulty

    # -- install / uninstall ------------------------------------------------- #
    def install(self) -> "FaultPlan":
        if self._originals:
            raise RuntimeError("FaultPlan already installed")
        for name in self.entry_points:
            orig = getattr(kops, name)
            wrapped = self.wrap(name, orig)
            if wrapped is not orig:
                self._originals[name] = orig
                setattr(kops, name, wrapped)
        for r in self.rules:  # one-shot corruption rules fire at install
            if r.kind == "cache_corrupt":
                with self._lock:
                    keys = corrupt_tuning_cache(self._rng, r.rate)
                    self.corrupted_keys += tuple(keys)
                    by_kind = self.injected.setdefault("tuning_cache", {})
                    by_kind["cache_corrupt"] = (
                        by_kind.get("cache_corrupt", 0) + len(keys)
                    )
        _ACTIVE.append(self)
        return self

    def uninstall(self) -> None:
        for name, orig in self._originals.items():
            setattr(kops, name, orig)
        self._originals.clear()
        if self in _ACTIVE:
            _ACTIVE.remove(self)

    def __enter__(self) -> "FaultPlan":
        return self.install()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.uninstall()
