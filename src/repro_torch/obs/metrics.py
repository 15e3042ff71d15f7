"""Process-wide metrics registry (a copy of ``repro.obs.metrics``; the port
imports nothing of the JAX package): named counters, gauges, and
bounded-reservoir histograms with a label system.

Before this module, every subsystem grew its own counter dict --
``ops._CONV_FALLBACKS``, the executor's ``_GUARD_FALLBACKS``, per-server
``_PlanEntry.stats`` -- none sharing a schema or an export path.  This
registry is the one place those numbers live (the old accessors are now
*views* over it), and the one place an external system scrapes:

* :class:`MetricsRegistry` -- a named family per metric (``counter`` /
  ``gauge`` / ``histogram``), each holding one **series** per label set
  (``plan``, ``op``, ``scheme``, ``backend``, ``reason``, ...).  Label
  values are stringified; a family's label *names* are pinned by its first
  series, so a typo'd label set fails loudly instead of forking the family.
* **bounded reservoirs** -- histograms keep the most recent ``reservoir``
  observations for percentiles but accumulate ``count``/``sum``/``min``/
  ``max`` over *every* observation, so a long-running server plateaus in
  memory while its totals stay exact.
* **exporters** -- :meth:`snapshot` (plain dicts), :meth:`to_json`, and
  :meth:`to_prometheus` (text exposition format: counters/gauges verbatim,
  histograms as summary-style quantiles + ``_count``/``_sum``).
* **state transplant** -- :meth:`dump_state` / :meth:`load_state` give the
  test suite's global-state-isolation fixture an exact snapshot/restore,
  the same contract the TuningCache singleton already honors.

The module-level :func:`registry` returns the process singleton; handles
are cheap enough to resolve at the call site::

    from repro_torch.obs import metrics
    metrics.registry().counter("conv_fallback_total", reason="groups").inc()

This module is a leaf: stdlib-only, importable from anywhere in the repo
(kernels, executor, serving) without cycles.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Deque, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry",
]

#: default histogram reservoir: matches the serving latency reservoir bound
DEFAULT_RESERVOIR = 4096

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Series:
    """One (family, label-set) time series.  Counters/gauges hold a float;
    histograms add a bounded reservoir plus exact running aggregates."""

    __slots__ = ("value", "reservoir", "count", "sum", "min", "max")

    def __init__(self, reservoir: Optional[int] = None):
        self.value = 0.0
        self.reservoir: Optional[Deque[float]] = (
            None if reservoir is None else deque(maxlen=reservoir)
        )
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None


class _Handle:
    """Caller-facing view of one series.  Mutations go through the owning
    registry's lock, so handles are safe to cache and share across threads."""

    __slots__ = ("_reg", "name", "labels", "_series")

    def __init__(self, reg: "MetricsRegistry", name: str, labels: LabelKey,
                 series: _Series):
        self._reg = reg
        self.name = name
        self.labels = dict(labels)
        self._series = series


class Counter(_Handle):
    """Monotonic count.  ``inc`` with a negative amount is a bug upstream
    and raises -- a counter that can go down is a gauge."""

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({amount})")
        with self._reg._lock:
            self._series.value += amount

    @property
    def value(self) -> float:
        with self._reg._lock:
            return self._series.value


class Gauge(_Handle):
    """Point-in-time value; ``set`` overwrites, ``set_max`` keeps the
    high-water mark (queue-depth peaks), ``add`` adjusts in place."""

    def set(self, value: float) -> None:
        with self._reg._lock:
            self._series.value = float(value)

    def set_max(self, value: float) -> None:
        with self._reg._lock:
            self._series.value = max(self._series.value, float(value))

    def add(self, amount: float) -> None:
        with self._reg._lock:
            self._series.value += amount

    @property
    def value(self) -> float:
        with self._reg._lock:
            return self._series.value


class Histogram(_Handle):
    """Bounded-reservoir distribution: percentiles come from the most
    recent ``reservoir`` observations, count/sum/min/max from all of them."""

    def observe(self, value: float) -> None:
        v = float(value)
        with self._reg._lock:
            s = self._series
            s.reservoir.append(v)
            s.count += 1
            s.sum += v
            s.min = v if s.min is None else min(s.min, v)
            s.max = v if s.max is None else max(s.max, v)

    @property
    def count(self) -> int:
        with self._reg._lock:
            return self._series.count

    @property
    def sum(self) -> float:
        with self._reg._lock:
            return self._series.sum

    def percentile(self, q: float) -> float:
        """Linear-interpolated percentile (``q`` in [0, 100]) over the
        reservoir; 0.0 when nothing has been observed."""
        with self._reg._lock:
            data = sorted(self._series.reservoir)
        if not data:
            return 0.0
        if len(data) == 1:
            return data[0]
        rank = (q / 100.0) * (len(data) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(data) - 1)
        frac = rank - lo
        return data[lo] * (1.0 - frac) + data[hi] * frac

    def stats(self) -> Dict[str, float]:
        """The standard latency reduction: count/mean/p50/p95/p99."""
        with self._reg._lock:
            count, total = self._series.count, self._series.sum
        return {
            "count": count,
            "mean": (total / count) if count else 0.0,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    __slots__ = ("name", "kind", "help", "reservoir", "label_names", "series")

    def __init__(self, name: str, kind: str, help: str, reservoir: Optional[int]):
        self.name = name
        self.kind = kind
        self.help = help
        self.reservoir = reservoir
        #: pinned by the first series: all series of a family share a schema
        self.label_names: Optional[Tuple[str, ...]] = None
        self.series: Dict[LabelKey, _Series] = {}


class MetricsRegistry:
    """Thread-safe named-metric registry; see the module docstring.  The
    process singleton is :func:`registry`; fresh instances are cheap (tests
    use private ones to probe semantics without touching global state)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}

    # -- family / series resolution ------------------------------------------ #
    def _resolve(self, name: str, kind: str, help: str,
                 reservoir: Optional[int], labels: Dict[str, Any]) -> _Handle:
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(name, kind, help, reservoir)
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} is a {fam.kind}, not a {kind} -- one "
                    f"name, one type"
                )
            names = tuple(k for k, _ in key)
            if fam.label_names is None:
                fam.label_names = names
            elif fam.label_names != names:
                raise ValueError(
                    f"metric {name!r} takes labels {fam.label_names}, "
                    f"got {names} -- label names are pinned per family"
                )
            s = fam.series.get(key)
            if s is None:
                s = fam.series[key] = _Series(
                    fam.reservoir if kind == "histogram" else None
                )
            return _KINDS[kind](self, name, key, s)

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._resolve(name, "counter", help, None, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._resolve(name, "gauge", help, None, labels)

    def histogram(self, name: str, help: str = "",
                  reservoir: int = DEFAULT_RESERVOIR, **labels) -> Histogram:
        return self._resolve(name, "histogram", help, reservoir, labels)

    # -- views ----------------------------------------------------------------- #
    def series(self, name: str) -> List[Tuple[Dict[str, str], _Series]]:
        """(labels dict, series) per series of ``name``; [] if unknown --
        the raw material of the back-compat counter views."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return []
            return [(dict(k), s) for k, s in fam.series.items()]

    def label_counts(self, name: str, *label_names: str) -> Dict[str, float]:
        """Collapse a counter family to ``{"v1[/v2/...]": value}`` over the
        given label names -- the shape of the legacy counter dicts
        (``conv_fallback_counts`` et al.)."""
        out: Dict[str, float] = {}
        for labels, s in self.series(name):
            key = "/".join(labels.get(ln, "") for ln in label_names)
            out[key] = out.get(key, 0.0) + s.value
        return out

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._families)

    # -- reset / state transplant ---------------------------------------------- #
    def reset(self, name: Optional[str] = None) -> None:
        """Drop every series of ``name`` (or every family when None).  The
        family itself survives a named reset so its type/labels stay pinned."""
        with self._lock:
            if name is None:
                self._families.clear()
            elif name in self._families:
                self._families[name].series.clear()

    def dump_state(self) -> Dict[str, Any]:
        """Deep-copy of the full registry state, suitable for
        :meth:`load_state` (the conftest isolation fixture's snapshot)."""
        with self._lock:
            out: Dict[str, Any] = {}
            for name, fam in self._families.items():
                out[name] = {
                    "kind": fam.kind,
                    "help": fam.help,
                    "reservoir": fam.reservoir,
                    "label_names": fam.label_names,
                    "series": {
                        k: {
                            "value": s.value,
                            "reservoir": None if s.reservoir is None
                            else list(s.reservoir),
                            "count": s.count,
                            "sum": s.sum,
                            "min": s.min,
                            "max": s.max,
                        }
                        for k, s in fam.series.items()
                    },
                }
            return out

    def load_state(self, state: Dict[str, Any]) -> None:
        """Restore exactly the families/series of ``state`` (not a merge:
        families created since the snapshot are discarded)."""
        with self._lock:
            self._families.clear()
            for name, f in state.items():
                fam = _Family(name, f["kind"], f["help"], f["reservoir"])
                fam.label_names = (
                    None if f["label_names"] is None else tuple(f["label_names"])
                )
                for k, sv in f["series"].items():
                    s = _Series(f["reservoir"] if f["kind"] == "histogram" else None)
                    s.value = sv["value"]
                    if sv["reservoir"] is not None:
                        s.reservoir.extend(sv["reservoir"])
                    s.count, s.sum = sv["count"], sv["sum"]
                    s.min, s.max = sv["min"], sv["max"]
                    fam.series[tuple(tuple(p) for p in k)] = s
                self._families[name] = fam

    # -- exporters -------------------------------------------------------------- #
    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view of every family: the JSON-export payload and the
        ``--metrics-dump`` record."""
        with self._lock:
            out: Dict[str, Any] = {}
            for name, fam in sorted(self._families.items()):
                samples = []
                for key, s in fam.series.items():
                    sample: Dict[str, Any] = {"labels": dict(key)}
                    if fam.kind == "histogram":
                        data = sorted(s.reservoir)
                        sample.update(
                            count=s.count, sum=s.sum, min=s.min, max=s.max,
                            p50=_pct(data, 50), p95=_pct(data, 95),
                            p99=_pct(data, 99),
                        )
                    else:
                        sample["value"] = s.value
                    samples.append(sample)
                out[name] = {"type": fam.kind, "help": fam.help,
                             "samples": samples}
            return out

    def to_json(self, **json_kwargs) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, **json_kwargs)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format.  Histograms export as
        summaries (``{quantile="0.5"}`` series + ``_count``/``_sum``) --
        reservoir percentiles, not cumulative buckets."""
        lines: List[str] = []
        snap = self.snapshot()
        for name, fam in snap.items():
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            kind = "summary" if fam["type"] == "histogram" else fam["type"]
            lines.append(f"# TYPE {name} {kind}")
            for s in fam["samples"]:
                base = s["labels"]
                if fam["type"] == "histogram":
                    for q, field in (("0.5", "p50"), ("0.95", "p95"),
                                     ("0.99", "p99")):
                        lines.append(_prom_line(
                            name, {**base, "quantile": q}, s[field]
                        ))
                    lines.append(_prom_line(f"{name}_count", base, s["count"]))
                    lines.append(_prom_line(f"{name}_sum", base, s["sum"]))
                else:
                    lines.append(_prom_line(name, base, s["value"]))
        return "\n".join(lines) + ("\n" if lines else "")


def _pct(data: List[float], q: float) -> float:
    if not data:
        return 0.0
    if len(data) == 1:
        return data[0]
    rank = (q / 100.0) * (len(data) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(data) - 1)
    frac = rank - lo
    return data[lo] * (1.0 - frac) + data[hi] * frac


def _prom_line(name: str, labels: Dict[str, str], value: Any) -> str:
    if labels:
        body = ",".join(
            f'{k}="{_prom_escape(v)}"' for k, v in sorted(labels.items())
        )
        return f"{name}{{{body}}} {_prom_value(value)}"
    return f"{name} {_prom_value(value)}"


def _prom_escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_value(v: Any) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry every subsystem records into."""
    return _REGISTRY


def iter_series(name: str) -> Iterator[Tuple[Dict[str, str], float]]:
    """Convenience over the singleton: (labels, value) per series."""
    for labels, s in _REGISTRY.series(name):
        yield labels, s.value
