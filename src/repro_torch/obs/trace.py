"""Structured tracing: nestable spans emitting Chrome-trace-format JSON (a
copy of ``repro.obs.trace``; the port imports nothing of the JAX package).

The output of a traced run loads directly into ``chrome://tracing`` or
Perfetto (https://ui.perfetto.dev): duration events (``ph: "B"/"E"``) nest
per thread into the familiar flame view, instant events (``ph: "i"``) mark
point occurrences (guard demotions, watchdog trips), and async events
(``ph: "b"/"n"/"e"`` with an ``id``) follow a serving request across
threads from admission to completion.

Overhead contract (gated for the JAX copy by ``benchmarks/obs_bench.py``):

* **disabled** (the default): every hook is guarded by the module-level
  :func:`enabled` flag; :func:`span` returns one shared no-op singleton and
  :func:`instant` returns before building anything, so an untraced run
  allocates nothing and pays one predictable branch per hook (<= 1% on an
  end-to-end demo-app plan).
* **enabled**: each span appends two small dicts to an in-memory buffer
  under a lock (<= 5% end to end).  Nothing is serialized until
  :meth:`TraceBuffer.chrome_trace` / :meth:`TraceBuffer.save`.

The clock is injectable per buffer (``start_tracing(clock=...)``) so tests
assert exact durations; timestamps are emitted in microseconds, the Chrome
trace unit.  Tracing state is process-global by design -- one switch arms
every instrumented layer (executor steps, compiler passes, serving
requests) -- and :func:`state` / :func:`restore` give the test-isolation
fixture an exact snapshot, like the metrics registry's ``dump_state``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "TraceBuffer",
    "enabled",
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

#: hot-path switch: every instrumentation hook reads this module attribute
#: first and bails before allocating anything when tracing is off
_ENABLED = False
_BUFFER: Optional["TraceBuffer"] = None
_LOCK = threading.Lock()  # guards the enable/disable transitions only


def enabled() -> bool:
    return _ENABLED


class TraceBuffer:
    """An in-memory list of Chrome-trace events with its own clock.

    Recording is lock-free: ``list.append`` is atomic under the GIL, and
    ``add`` is bound straight to it so the hot path is one C call --
    the <= 5% traced-mode gate in ``benchmarks/obs_bench.py`` leans on
    this.  Readers snapshot via ``list(...)`` (also atomic), so
    cross-thread produce/read interleavings are safe without a mutex."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.pid = os.getpid()
        self._events: List[Dict[str, Any]] = []
        #: append one raw Chrome-trace event dict (the hot path)
        self.add = self._events.append

    # -- recording -------------------------------------------------------------- #
    def now_us(self) -> float:
        return self.clock() * 1e6

    def __len__(self) -> int:
        return len(self._events)

    @property
    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    # -- export ----------------------------------------------------------------- #
    def chrome_trace(self) -> Dict[str, Any]:
        """The JSON-object Chrome trace form (Perfetto-loadable)."""
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
        return os.path.abspath(path)

    # -- structured views -------------------------------------------------------- #
    def spans(self) -> List[Dict[str, Any]]:
        """Pair the B/E duration events per thread into
        ``{name, cat, ts, dur, args, tid}`` dicts (start order).  Raises on
        mismatched pairs -- the trace-validity check the tests drive."""
        stacks: Dict[int, List[Dict[str, Any]]] = {}
        out: List[Dict[str, Any]] = []
        for ev in self.events:
            ph = ev.get("ph")
            if ph == "B":
                rec = {
                    "name": ev["name"], "cat": ev.get("cat", ""),
                    "ts": ev["ts"], "dur": None,
                    "args": ev.get("args", {}), "tid": ev["tid"],
                }
                stacks.setdefault(ev["tid"], []).append(rec)
                out.append(rec)
            elif ph == "E":
                stack = stacks.get(ev["tid"])
                if not stack:
                    raise ValueError(
                        f"unbalanced trace: E event with empty stack on "
                        f"tid {ev['tid']}"
                    )
                rec = stack.pop()
                rec["dur"] = ev["ts"] - rec["ts"]
        dangling = [r["name"] for s in stacks.values() for r in s]
        if dangling:
            raise ValueError(f"unbalanced trace: unclosed spans {dangling}")
        return out

    def instants(self, cat: Optional[str] = None) -> List[Dict[str, Any]]:
        return [
            ev for ev in self.events
            if ev.get("ph") == "i" and (cat is None or ev.get("cat") == cat)
        ]

    def async_events(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        return [
            ev for ev in self.events
            if ev.get("ph") in ("b", "n", "e")
            and (name is None or ev.get("name") == name)
        ]


class _Span:
    """A live duration event: B recorded at ``__enter__``, E at
    ``__exit__``.  ``set`` mutates the B event's args in place (the dict is
    not serialized until export), so callers can attach results computed
    mid-span -- output shapes, demotion verdicts -- without a second event."""

    __slots__ = ("_buf", "_begin")

    def __init__(self, buf: TraceBuffer, name: str, cat: str,
                 args: Dict[str, Any]):
        self._buf = buf
        self._begin = {
            "name": name, "cat": cat, "ph": "B", "pid": buf.pid,
            "tid": _get_ident(), "ts": buf.clock() * 1e6, "args": args,
        }

    def __enter__(self) -> "_Span":
        self._buf.add(self._begin)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        b = self._begin
        if exc_type is not None:
            b["args"]["error"] = exc_type.__name__
        buf = self._buf
        buf.add({
            "name": b["name"], "cat": b["cat"], "ph": "E", "pid": b["pid"],
            "tid": b["tid"], "ts": buf.clock() * 1e6,
        })
        return False

    def set(self, key: str, value: Any) -> None:
        self._begin["args"][key] = value


class _NullSpan:
    """The shared disabled-mode span: no state, no allocation, reusable and
    re-entrant (``__enter__`` returns self, every method is a no-op)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, key: str, value: Any) -> None:
        pass


NULL_SPAN = _NullSpan()

_get_ident = threading.get_ident  # module-global bind: hot-path lookup


def span(name: str, cat: str = "repro", **args):
    """A nestable duration span (``with span("step", op="conv2d"): ...``).
    Returns the shared :data:`NULL_SPAN` when tracing is disabled."""
    buf = _BUFFER
    if not _ENABLED or buf is None:
        return NULL_SPAN
    return _Span(buf, name, cat, args)


def instant(name: str, cat: str = "repro", **args) -> None:
    """A point event (``ph: "i"``, thread scope) -- demotions, fallbacks,
    watchdog trips.  No-op when disabled."""
    buf = _BUFFER
    if not _ENABLED or buf is None:
        return
    buf.add({
        "name": name, "cat": cat, "ph": "i", "s": "t", "pid": buf.pid,
        "tid": _get_ident(), "ts": buf.now_us(), "args": args,
    })


def _async_event(ph: str, name: str, event_id, cat: str, args) -> None:
    buf = _BUFFER
    if not _ENABLED or buf is None:
        return
    buf.add({
        "name": name, "cat": cat, "ph": ph, "id": str(event_id),
        "pid": buf.pid, "tid": _get_ident(), "ts": buf.now_us(),
        "args": args,
    })


def async_begin(name: str, event_id, cat: str = "repro", **args) -> None:
    """Open an async span (``ph: "b"``): a logical operation that crosses
    threads -- e.g. a serving request from admission to completion."""
    _async_event("b", name, event_id, cat, args)


def async_instant(name: str, event_id, cat: str = "repro", **args) -> None:
    """A milestone inside an open async span (``ph: "n"``) -- e.g. the
    moment a queued request is picked into a macro-batch."""
    _async_event("n", name, event_id, cat, args)


def async_end(name: str, event_id, cat: str = "repro", **args) -> None:
    _async_event("e", name, event_id, cat, args)


# --------------------------------------------------------------------------- #
# session control                                                              #
# --------------------------------------------------------------------------- #


def start_tracing(clock=time.perf_counter) -> TraceBuffer:
    """Arm tracing with a fresh buffer (replacing any active one) and
    return it.  The injectable ``clock`` is seconds-valued; events are
    stamped in microseconds."""
    global _ENABLED, _BUFFER
    with _LOCK:
        _BUFFER = TraceBuffer(clock)
        _ENABLED = True
        return _BUFFER


def stop_tracing() -> Optional[TraceBuffer]:
    """Disarm tracing; returns the buffer that was recording (if any)."""
    global _ENABLED, _BUFFER
    with _LOCK:
        buf, _BUFFER = _BUFFER, None
        _ENABLED = False
        return buf


class tracing:
    """``with tracing() as buf: ...`` -- scoped session that restores the
    *previous* tracing state on exit, so nested sessions compose."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._prev: Optional[Tuple[bool, Optional[TraceBuffer]]] = None
        self.buffer: Optional[TraceBuffer] = None

    def __enter__(self) -> TraceBuffer:
        self._prev = state()
        self.buffer = start_tracing(self._clock)
        return self.buffer

    def __exit__(self, exc_type, exc, tb) -> bool:
        restore(self._prev)
        return False


def current_buffer() -> Optional[TraceBuffer]:
    return _BUFFER


def state() -> Tuple[bool, Optional[TraceBuffer]]:
    """(enabled, buffer) -- the exact switch state, for snapshot/restore
    (the conftest isolation fixture and nested ``tracing`` sessions)."""
    return (_ENABLED, _BUFFER)


def restore(snap: Tuple[bool, Optional[TraceBuffer]]) -> None:
    global _ENABLED, _BUFFER
    with _LOCK:
        _ENABLED, _BUFFER = snap
