"""Plan profiler: run an ExecutionPlan under tracing and reduce it to a
per-step cost table (a port of ``repro.obs.profile``).

:func:`profile_plan` executes a compiled plan inside a private tracing
session (the caller's tracing state is restored afterwards), pairs the
per-step spans the executor emits, and joins them with the plan's meta-tensor
memory estimate into one row per step:

* **host ms** (``ms``, median over ``runs`` traced executions) and its share
  of the total (``pct``): the step span, which on the card is the time the
  host takes to *enqueue* the step's kernels -- launches are asynchronous;
* **device ms** (``device_ms`` / ``device_pct``, CUDA plans only): the time
  the card spends on the step, from CUDA events recorded between the steps
  of a run whose device queue is kept ahead of the host (below) -- its
  kernels and the card's idle between them (the card pauses between two
  queued kernels and around each event), so a step of many small kernels
  reads above the sum of its kernel times (``chip_smoke.py`` prints both);
* estimated bytes moved -- the step's input + parameter + output bytes from
  :meth:`ExecutionPlan.memory_estimate` (device traffic if nothing fuses);
* attribution -- whether the step dispatched a backend-specific handler
  (``kernel`` / ``quant``), the implementation shared with the reference
  table (``shared``), the ``reference`` table itself, or (guarded plans) was
  demoted to the reference handler mid-run (``demoted``).

How device ms keeps host time out: each traced run is followed by an
untraced one timed on the card.  Before it the stream gets a calibrated
``torch.cuda._sleep`` longer than the host needs to enqueue the run, then a
start event; an event is recorded after every step (through the executor's
``observer`` hook).  Step i's device ms is
the time between the event before it and its own.  When the last step is
enqueued the start event must not have been reached (``query()`` False):
then the card never waited for the host inside the run.  If it had been
reached, the run is repeated with a longer sleep and, from the third try,
in windows of fewer steps, each behind its own sleep and start event (a
long plan can fill the driver's launch queue, which blocks the host until
the card drains it); after :data:`DEVICE_ATTEMPTS` tries it raises -- an
enqueue-polluted number is never reported.  Guarded plans synchronize the
host at every step (the NaN / Inf check), so no queue can be kept ahead:
their ``device_ms`` is ``None`` with a ``device_note`` saying why, as it is
on the CPU.

Surfaces: ``python -m repro_torch.launch.profile`` (text table + Chrome
trace out) and ``chip_smoke.py``'s ``== profile`` phase.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import trace as _trace

__all__ = ["StepProfile", "PlanProfile", "profile_plan", "DEVICE_ATTEMPTS"]

#: traced runs tried before device timing gives up on keeping the card's
#: queue ahead of the host
DEVICE_ATTEMPTS = 6


@dataclasses.dataclass
class StepProfile:
    name: str
    op: str
    ms: float  # host ms of the step span (the enqueue, on the card)
    pct: float
    bytes_moved: int
    attribution: str  # "kernel" | "quant" | "reference" | "shared" | "demoted"
    out_shape: Tuple[int, ...]
    demotions: int = 0
    device_ms: Optional[float] = None
    device_pct: Optional[float] = None


@dataclasses.dataclass
class PlanProfile:
    backend: str
    steps: List[StepProfile]
    total_ms: float  # host ms, summed over the steps
    runs: int
    memory: Dict[str, Any]
    trace: Optional[Any] = None  # TraceBuffer of the last traced run
    device: str = "cpu"
    total_device_ms: Optional[float] = None
    #: why ``device_ms`` is None (CPU plan, guarded plan), else None
    device_note: Optional[str] = None
    #: sleep-guarded windows the last traced run was timed in (CUDA only)
    device_windows: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {
            "backend": self.backend,
            "device": self.device,
            "total_ms": self.total_ms,
            "total_device_ms": self.total_device_ms,
            "device_note": self.device_note,
            "runs": self.runs,
            "peak_activation_bytes": self.memory["peak_activation_bytes"],
            "param_bytes": self.memory["param_bytes"],
            "steps": [dataclasses.asdict(s) for s in self.steps],
        }

    def save_json(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        return os.path.abspath(path)

    def render_text(self, top: Optional[int] = None, by: str = "host") -> str:
        """Aligned per-step table, hottest first by host ms (``by="host"``)
        or device ms (``by="device"``); ``top`` truncates."""
        if by not in ("host", "device"):
            raise ValueError(f"by must be 'host' or 'device', got {by!r}")
        if by == "device" and self.total_device_ms is None:
            raise ValueError(f"no device times to sort by: {self.device_note}")
        key = (lambda s: -s.ms) if by == "host" else (lambda s: -s.device_ms)
        rows = sorted(self.steps, key=key)
        if top is not None:
            rows = rows[:top]
        name_w = max([len("step")] + [len(s.name) for s in rows])
        op_w = max([len("op")] + [len(s.op) for s in rows])
        dev = ("n/a" if self.total_device_ms is None
               else f"{self.total_device_ms:.3f}ms")
        head = (f"plan profile: backend={self.backend} device={self.device} "
                f"steps={len(self.steps)} host={self.total_ms:.3f}ms device={dev} "
                f"over {self.runs} run(s)")
        if self.device_note:
            head += f" ({self.device_note})"
        lines = [
            head,
            f"{'step':{name_w}s}  {'op':{op_w}s}  {'host ms':>9s}  {'%':>6s}  "
            f"{'dev ms':>9s}  {'dev %':>6s}  {'est bytes':>10s}  {'via':<9s}  out",
        ]
        for s in rows:
            via = s.attribution + (f"(x{s.demotions})" if s.demotions else "")
            if s.device_ms is None:
                dms, dpct = "n/a", "n/a"
            else:
                dms, dpct = f"{s.device_ms:.4f}", f"{s.device_pct:5.1f}%"
            lines.append(
                f"{s.name:{name_w}s}  {s.op:{op_w}s}  {s.ms:9.3f}  "
                f"{s.pct:5.1f}%  {dms:>9s}  {dpct:>6s}  "
                f"{_human_bytes(s.bytes_moved):>10s}  {via:<9s}  {list(s.out_shape)}"
            )
        return "\n".join(lines)


def _human_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}GB"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _attribution(plan) -> Dict[str, str]:
    """op -> how this plan's backend dispatches it: a backend-specific
    handler ("kernel"/"quant"/"reference") or the implementation shared
    with the reference table ("shared")."""
    from ..core.graph.executor import handlers_for

    ref = handlers_for("reference")
    label = plan.guard.primary if plan.backend == "guarded" else plan.backend
    primary = handlers_for(label)
    out: Dict[str, str] = {}
    for step in plan.steps:
        op = step.node.op
        if label == "reference":
            out[op] = "reference"
            continue
        h = primary.get(op, ref.get(op))
        out[op] = "shared" if h is ref.get(op) else label
    return out


def _sleep_cycles_per_ms() -> float:
    """Clock cycles ``torch.cuda._sleep`` spins a millisecond on the current
    device, from one timed sleep."""
    cycles = 2_000_000
    torch.cuda._sleep(cycles)  # first call: the spin kernel's own set-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / max(start.elapsed_time(end), 1e-3)


class _DeviceClock:
    """The events of one traced run: a sleep + start event ahead of each
    window of ``window`` steps, one event after every step (the executor's
    observer hook; graph inputs skipped), and the check that each window's
    start was still pending when its last step had been enqueued."""

    def __init__(self, n_inputs: int, n_steps: int, window: int, sleep_cycles: int):
        self.n_inputs, self.n_steps, self.window = n_inputs, n_steps, window
        self.sleep_cycles = sleep_cycles
        self.seen = 0
        self.starts: List[Any] = []
        self.events: List[Any] = []
        self.ok = True
        #: the step that closed the first window whose start the card had
        #: already reached (a step that syncs the host shows here)
        self.late_step: Optional[str] = None

    def open_window(self) -> None:
        torch.cuda._sleep(self.sleep_cycles)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.starts.append(ev)

    def __call__(self, name: str, value: Any) -> None:
        self.seen += 1
        if self.seen <= self.n_inputs:  # the hook also sees the graph inputs
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        i = len(self.events)
        if i % self.window == 0 or i == self.n_steps:
            # the window's last step is enqueued: the card must not have
            # reached the window's start yet
            if self.ok and self.starts[-1].query():
                self.ok, self.late_step = False, name
            if i < self.n_steps:
                self.open_window()

    def step_ms(self) -> List[float]:
        out = []
        for i, ev in enumerate(self.events):
            prev = self.starts[i // self.window] if i % self.window == 0 else self.events[i - 1]
            out.append(prev.elapsed_time(ev))
        return out


def profile_plan(
    plan,
    params,
    *args,
    runs: int = 1,
    warmup: int = 1,
    clock=time.perf_counter,
) -> PlanProfile:
    """Execute ``plan(params, *args)`` under tracing and reduce the per-step
    spans (and, on the card, the per-step device times) to a
    :class:`PlanProfile`.  ``warmup`` untraced runs absorb the kernels'
    first launches (and size the sleep that keeps the card's queue ahead of
    the host); ``runs`` traced runs are reduced to a per-step *median* so
    one pause cannot masquerade as a hot step.  The caller's tracing state
    is saved and restored around the session."""
    if runs < 1 or warmup < 0:
        raise ValueError(f"need runs >= 1, warmup >= 0; got {runs}/{warmup}")
    dev = plan.device
    # inputs on the plan's device before any timing: a host -> device copy
    # inside a run would be part of the first step
    args = tuple(torch.as_tensor(a, device=dev) for a in args)
    cuda = dev.type == "cuda"
    guarded = plan.backend == "guarded"
    timed = cuda and not guarded
    host_call_ms = 0.0
    with torch.no_grad():
        for _ in range(warmup):
            t0 = time.perf_counter()
            plan(params, *args)
            host_call_ms = max(host_call_ms, (time.perf_counter() - t0) * 1e3)
            if cuda:
                torch.cuda.synchronize(dev)

    n_steps = len(plan.steps)
    prev = _trace.state()
    per_step_dev: List[List[float]] = [[] for _ in range(n_steps)]
    windows = 0
    try:
        buf = _trace.start_tracing(clock)
        with torch.no_grad(), torch.cuda.device(dev) if cuda else contextlib.nullcontext():
            cycles_per_ms = _sleep_cycles_per_ms() if timed else 0.0
            for _ in range(runs):
                # host ms: a traced run as the plan runs in service
                plan(params, *args)
                if cuda:
                    torch.cuda.synchronize(dev)
                if not timed:
                    continue
                # device ms: an untraced run behind the sleep (its host
                # times would include waits on a full launch queue)
                _trace.restore((False, None))
                dc = _timed_run(plan, params, args, n_steps, host_call_ms, cycles_per_ms)
                _trace.restore((True, buf))
                windows = len(dc.starts)
                for i, ms in enumerate(dc.step_ms()):
                    per_step_dev[i].append(ms)
    finally:
        _trace.restore(prev)

    step_spans = [s for s in buf.spans() if s["cat"] == "step"]
    if len(step_spans) != runs * n_steps:
        raise RuntimeError(
            f"expected {runs}x{n_steps} step spans, got {len(step_spans)} -- "
            "was tracing toggled mid-run?"
        )
    demote_ts = [
        (ev["tid"], ev["ts"]) for ev in buf.instants("guard")
        if ev["name"].startswith("demote:")
    ]

    # per-step median over the runs (spans arrive in execution order)
    per_step_ms: List[List[float]] = [[] for _ in range(n_steps)]
    demotions = [0] * n_steps
    for r in range(runs):
        for i in range(n_steps):
            sp = step_spans[r * n_steps + i]
            per_step_ms[i].append(sp["dur"] / 1e3)
            demotions[i] += sum(
                1 for tid, ts in demote_ts
                if tid == sp["tid"] and sp["ts"] <= ts <= sp["ts"] + sp["dur"]
            )

    mem = plan.memory_estimate(*args)
    out_bytes = {name: b for name, b, _live in mem["per_step"]}
    # bytes moved = inputs + params + output of each step (name -> bytes of
    # every value the step touches; graph inputs seed the map)
    val_bytes: Dict[str, int] = {
        name: _nbytes(a) for name, a in zip(plan.graph.inputs, args)
    }
    attribution = _attribution(plan)
    rows: List[StepProfile] = []
    for i, step in enumerate(plan.steps):
        n = step.node
        pbytes = sum(
            _nbytes(v) for v in params.get(n.name, {}).values() if isinstance(v, torch.Tensor)
        )
        in_bytes = sum(val_bytes.get(x, 0) for x in n.inputs)
        val_bytes[n.name] = out_bytes.get(n.name, 0)
        attr = "demoted" if demotions[i] else attribution[n.op]
        rows.append(StepProfile(
            name=n.name, op=n.op, ms=statistics.median(per_step_ms[i]), pct=0.0,
            bytes_moved=in_bytes + pbytes + out_bytes.get(n.name, 0),
            attribution=attr,
            out_shape=tuple(step_spans[i]["args"].get("out_shape", ())),
            demotions=demotions[i],
            device_ms=statistics.median(per_step_dev[i]) if timed else None,
        ))
    total_ms = sum(r.ms for r in rows)
    total_dev = sum(r.device_ms for r in rows) if timed else None
    for r in rows:
        r.pct = (100.0 * r.ms / total_ms) if total_ms else 0.0
        if timed:
            r.device_pct = (100.0 * r.device_ms / total_dev) if total_dev else 0.0
    note = None
    if not cuda:
        note = f"{dev.type} plan: no device clock"
    elif guarded:
        note = ("guarded plan: the NaN/Inf check syncs the host at every step, "
                "so no device queue can be kept ahead of it")
    return PlanProfile(
        backend=plan.backend, steps=rows, total_ms=total_ms, runs=runs,
        memory={k: mem[k] for k in ("peak_activation_bytes", "param_bytes",
                                    "param_bytes_by_dtype", "weight_bytes_saved")},
        trace=buf, device=str(dev), total_device_ms=total_dev, device_note=note,
        device_windows=windows,
    )


def _timed_run(plan, params, args, n_steps, host_call_ms, cycles_per_ms) -> _DeviceClock:
    """One run with device events, repeated until every window's start was
    still pending when its last step was enqueued (see the module doc): the
    second try sleeps twice as long a window, every later one halves the
    window."""
    window, margin = n_steps, 2.0
    for attempt in range(DEVICE_ATTEMPTS):
        # each window's sleep outlasts its share of a host plan call
        sleep_ms = margin * host_call_ms * window / n_steps + 1.0
        dc = _DeviceClock(len(plan.graph.inputs), n_steps, window,
                          int(sleep_ms * cycles_per_ms))
        t0 = time.perf_counter()
        dc.open_window()
        plan.run_steps(params, *args, observer=dc)
        elapsed = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if dc.ok:
            return dc
        late = dc.late_step
        if host_call_ms == 0.0:  # no warm-up run measured the host
            host_call_ms = elapsed
        if attempt == 0:
            margin *= 2
        else:  # a window of fewer steps fits the driver's launch queue
            window = max(1, window // 2)
    raise RuntimeError(
        f"profile_plan: the card caught up with the host in every one of "
        f"{DEVICE_ATTEMPTS} tries (last window {window} steps, sleep {sleep_ms:.1f} ms, "
        f"first late window closed by step {late!r}: does it sync the host?); device "
        "times would include enqueue time"
    )
