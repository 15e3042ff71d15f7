"""The port's observability (``repro_torch.obs``) on the CPU: a twin of
``tests/test_obs.py`` for everything the port has, plus the port's own
additions.

* metrics-registry semantics (types, label pinning, bounded reservoirs,
  exporters, state transplant) and structured tracing (nesting with an
  injectable clock, Chrome-trace validity, the disabled fast path, nested
  sessions, cross-thread async events);
* the wiring through the executor, pass manager and ``AsyncPlanServer``:
  one step span per plan step for every app, nothing when untraced, guard
  demotions in the registry and in the spans, one batch per request, a
  shed request's span ended;
* ``profile_plan``: rows equal to steps, a valid Chrome trace, no device ms
  on the CPU (nor for a guarded plan), and -- on plans built from the same
  numpy-seeded weights -- ``bytes_moved`` and ``attribution`` per step
  equal to the JAX package's ``profile_plan`` for the ``reference``,
  ``kernel``, ``quant`` and ``guarded`` backends (the JAX plans run as
  ``tests/test_obs.py`` runs them: Pallas in interpret mode);
* the device clock's windows and retries, driven with stand-in CUDA events;
* the ``launch/profile`` CLI with ``--device cpu`` and ``serve
  --metrics-dump``.
"""

import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import compile_plan as jcompile_plan
from repro.obs import profile_plan as jprofile_plan
from repro_torch.core.graph import (
    PassContext,
    PassManager,
    compile_plan,
    guard_fallback_counts,
    optimize,
)
from repro_torch.kernels import ops as tops
from repro_torch.launch import profile as tprofile
from repro_torch.launch import serve as tserve
from repro_torch.models import cnn as tcnn
from repro_torch.obs import metrics, profile_plan, trace
from repro_torch.obs import profile as tprof
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.robustness import FaultPlan, FaultRule
from repro_torch.serving import AsyncPlanServer
from test_torch_plan import app_case
from test_torch_quant import quant_case
from test_torch_robustness import _port_state  # noqa: F401 (autouse fixture)

APPS = ["style_transfer", "coloring", "super_resolution"]


def _plan(app="super_resolution", backend="reference"):
    g = tcnn.APPS[app](torch.Generator().manual_seed(0), base=8, device="cpu")
    masks, structures = tcnn.app_masks(g, app, sparsity=0.5)
    go = optimize(g, masks, structures)
    return go, compile_plan(go, backend=backend, device="cpu")


def _frame(app, i=0, size=8):
    c = tcnn.APP_INPUT_CHANNELS[app]
    return torch.from_numpy(
        np.random.default_rng(i).standard_normal((c, size, size)).astype(np.float32))


# --------------------------------------------------------------------------- #
# metrics registry                                                             #
# --------------------------------------------------------------------------- #


def test_counter_semantics():
    r = MetricsRegistry()
    c = r.counter("hits_total", op="conv2d")
    c.inc()
    c.inc(4)
    assert c.value == 5
    assert r.counter("hits_total", op="conv2d").value == 5
    assert r.counter("hits_total", op="linear").value == 0
    with pytest.raises(ValueError):
        c.inc(-1)  # counters are monotonic


def test_gauge_set_max_keeps_high_water():
    r = MetricsRegistry()
    g = r.gauge("queue_peak", plan="sr")
    g.set_max(3)
    g.set_max(1)
    assert g.value == 3
    g.set(0.5)
    assert g.value == 0.5
    g.add(2)
    assert g.value == 2.5


def test_histogram_reservoir_is_bounded_but_totals_exact():
    r = MetricsRegistry()
    h = r.histogram("lat_ms", reservoir=100, plan="sr")
    for i in range(1000):
        h.observe(float(i))
    assert h.count == 1000
    assert h.sum == sum(range(1000))
    assert h.percentile(0) >= 900
    assert h.percentile(100) == 999
    s = h.stats()
    assert s["count"] == 1000 and 900 <= s["p50"] <= 999
    assert s["p95"] >= s["p50"] and s["p99"] >= s["p95"]


def test_type_collision_raises():
    r = MetricsRegistry()
    r.counter("x_total")
    with pytest.raises(ValueError, match="one name, one type"):
        r.gauge("x_total")
    with pytest.raises(ValueError, match="one name, one type"):
        r.histogram("x_total")


def test_label_names_pinned_per_family():
    r = MetricsRegistry()
    r.counter("y_total", op="conv2d", scheme="w8")
    r.counter("y_total", op="linear", scheme="f32").inc()
    with pytest.raises(ValueError, match="pinned"):
        r.counter("y_total", op="conv2d")
    with pytest.raises(ValueError, match="pinned"):
        r.counter("y_total", op="conv2d", backend="kernel", scheme="w8")


def test_label_counts_view_matches_legacy_shape():
    r = MetricsRegistry()
    r.counter("demote_total", op="conv2d", scheme="w8", reason="numeric").inc(2)
    r.counter("demote_total", op="linear", scheme="f32", reason="exception").inc()
    assert r.label_counts("demote_total", "op", "scheme", "reason") == {
        "conv2d/w8/numeric": 2.0,
        "linear/f32/exception": 1.0,
    }
    assert r.label_counts("unknown_total", "op") == {}


def test_snapshot_json_and_prometheus_exports():
    r = MetricsRegistry()
    r.counter("req_total", help="requests", plan="sr").inc(3)
    r.gauge("depth", plan="sr").set(2)
    h = r.histogram("lat_s", plan='s"r\n')
    h.observe(1.0)
    h.observe(3.0)
    snap = json.loads(r.to_json())
    assert snap["req_total"]["type"] == "counter"
    assert snap["req_total"]["samples"][0] == {"labels": {"plan": "sr"}, "value": 3.0}
    hs = snap["lat_s"]["samples"][0]
    assert hs["count"] == 2 and hs["sum"] == 4.0 and hs["p50"] == 2.0
    text = r.to_prometheus()
    assert "# TYPE req_total counter" in text
    assert 'req_total{plan="sr"} 3' in text
    assert "# TYPE lat_s summary" in text
    assert 'lat_s_count{plan="s\\"r\\n"} 2' in text
    assert 'quantile="0.5"' in text
    assert "# HELP req_total requests" in text


def test_dump_load_state_roundtrip_is_exact():
    r = MetricsRegistry()
    r.counter("a_total", k="v").inc(7)
    r.histogram("b_ms", reservoir=8).observe(1.5)
    state = r.dump_state()
    r.counter("a_total", k="v").inc()
    r.counter("c_total").inc()
    r.load_state(state)
    assert r.counter("a_total", k="v").value == 7
    assert "c_total" not in r.names()
    assert r.dump_state() == state
    r.histogram("b_ms", reservoir=8).observe(9.9)
    assert state["b_ms"]["series"][()]["reservoir"] == [1.5]


def test_reset_family_keeps_type_pinned():
    r = MetricsRegistry()
    r.counter("z_total", op="a").inc()
    r.reset("z_total")
    assert r.label_counts("z_total", "op") == {}
    with pytest.raises(ValueError):
        r.gauge("z_total")


# --------------------------------------------------------------------------- #
# tracing                                                                      #
# --------------------------------------------------------------------------- #


def test_span_nesting_with_injected_clock():
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]

    with trace.tracing(clock) as buf:
        with trace.span("outer", cat="t") as outer:
            with trace.span("inner", cat="t"):
                pass
            outer.set("k", "v")
    spans = buf.spans()
    assert [s["name"] for s in spans] == ["outer", "inner"]
    outer_s, inner_s = spans
    assert outer_s["dur"] == pytest.approx(3000.0)
    assert inner_s["dur"] == pytest.approx(1000.0)
    assert inner_s["ts"] > outer_s["ts"]
    assert inner_s["ts"] + inner_s["dur"] <= outer_s["ts"] + outer_s["dur"]
    assert outer_s["args"] == {"k": "v"}


def test_chrome_trace_validity_phases_pair_and_timestamps_monotonic():
    with trace.tracing() as buf:
        with trace.span("a"):
            trace.instant("mark", cat="g", why="test")
        with trace.span("b"):
            pass
    doc = buf.chrome_trace()
    assert doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]
    assert json.loads(json.dumps(doc)) == doc
    ts = [ev["ts"] for ev in events]
    assert ts == sorted(ts)
    assert {ev["ph"] for ev in events} == {"B", "E", "i"}
    assert all({"name", "ph", "pid", "tid", "ts"} <= set(ev) for ev in events)
    buf.spans()


def test_unbalanced_trace_is_detected():
    buf = trace.TraceBuffer()
    buf.add({"name": "x", "cat": "t", "ph": "B", "pid": 1, "tid": 1, "ts": 0.0, "args": {}})
    with pytest.raises(ValueError, match="unclosed"):
        buf.spans()
    buf2 = trace.TraceBuffer()
    buf2.add({"name": "x", "ph": "E", "pid": 1, "tid": 1, "ts": 0.0})
    with pytest.raises(ValueError, match="empty stack"):
        buf2.spans()


def test_span_error_annotated():
    with trace.tracing() as buf:
        with pytest.raises(RuntimeError):
            with trace.span("boom"):
                raise RuntimeError("x")
    (sp,) = buf.spans()
    assert sp["args"]["error"] == "RuntimeError"


def test_disabled_mode_is_allocation_free_and_inert():
    assert not trace.enabled()
    s1 = trace.span("a", op="x")
    s2 = trace.span("b")
    assert s1 is s2 is trace.NULL_SPAN
    with s1 as sp:
        sp.set("k", "v")
    trace.instant("never")
    trace.async_begin("never", 1)
    trace.async_end("never", 1)
    assert trace.current_buffer() is None


def test_tracing_context_restores_previous_session():
    outer = trace.start_tracing()
    try:
        trace.instant("outer-1")
        with trace.tracing() as inner:
            trace.instant("inner-1")
            assert trace.current_buffer() is inner
        assert trace.current_buffer() is outer
        trace.instant("outer-2")
        assert [e["name"] for e in outer.instants()] == ["outer-1", "outer-2"]
        assert [e["name"] for e in inner.instants()] == ["inner-1"]
    finally:
        trace.stop_tracing()


def test_async_events_cross_thread_ids():
    with trace.tracing() as buf:
        trace.async_begin("request", 7, cat="serving", plan="sr")

        def worker():
            trace.async_instant("request", 7, cat="serving", phase="batched")

        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
        trace.async_end("request", 7, cat="serving")
    evs = buf.async_events("request")
    assert [e["ph"] for e in evs] == ["b", "n", "e"]
    assert {e["id"] for e in evs} == {"7"}
    assert len({e["tid"] for e in evs}) == 2


def test_obs_package_exports_what_the_jax_package_exports():
    import repro.obs as jobs
    import repro_torch.obs as tobs

    assert tobs.__all__ == jobs.__all__
    assert all(hasattr(tobs, name) for name in tobs.__all__)


# --------------------------------------------------------------------------- #
# executor / pass-manager wiring                                               #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("app", APPS)
def test_per_step_spans_match_plan_step_count(app):
    go, plan = _plan(app)
    x = _frame(app)[None]
    with trace.tracing() as buf:
        y = plan(go.params, x)
    steps = [s for s in buf.spans() if s["cat"] == "step"]
    assert len(steps) == len(plan.steps)
    assert [s["name"] for s in steps] == [st.node.name for st in plan.steps]
    for s in steps:
        assert s["args"]["backend"] == "reference"
        assert s["args"]["op"]
        assert s["args"]["out_shape"]
    (plan_span,) = [s for s in buf.spans() if s["cat"] == "plan"]
    assert plan_span["args"]["steps"] == len(plan.steps)
    torch.testing.assert_close(y, plan(go.params, x), rtol=0, atol=0)


def test_untraced_run_emits_nothing():
    go, plan = _plan("coloring")
    with trace.tracing() as buf:
        pass
    plan(go.params, _frame("coloring")[None])
    assert len(buf) == 0


def test_pass_manager_emits_per_pass_spans():
    g = tcnn.APPS["coloring"](torch.Generator().manual_seed(0), base=8, device="cpu")
    masks, structures = tcnn.app_masks(g, "coloring", sparsity=0.5)
    pm = PassManager()
    with trace.tracing() as buf:
        pm.run(g, PassContext(masks=masks, structures=structures))
    passes = [s for s in buf.spans() if s["cat"] == "pass"]
    # skipped passes (needs_calibration without a table) emit no span
    assert [s["name"] for s in passes] == [p.name for p in pm.passes if p.name != "quantize"]
    assert all("changed" in s["args"] for s in passes)


def test_guard_demotions_hit_registry_and_spans():
    go, plan = _plan("coloring", backend="guarded")
    x = _frame("coloring")[None]
    before = sum(guard_fallback_counts().values())
    with FaultPlan([FaultRule("conv2d", "raise", rate=1.0)]):
        with trace.tracing() as buf:
            plan(go.params, x)
    counts = guard_fallback_counts()
    n_conv = sum(v for k, v in counts.items() if k.startswith("conv2d/"))
    assert n_conv >= 1 and sum(counts.values()) > before
    demoted = [s for s in buf.spans() if s["cat"] == "step" and s["args"].get("demoted")]
    assert len(demoted) >= 1
    reasons = {s["args"]["demoted"] for s in demoted}
    assert "exception" in reasons
    assert reasons <= {"exception", "breaker_open"}
    instants = buf.instants("guard")
    assert len(instants) == len(demoted)
    assert all(i["name"].startswith("demote:") for i in instants)
    assert [i["args"]["reason"] for i in instants] == [s["args"]["demoted"] for s in demoted]


def test_conv_fallback_counts_are_registry_views():
    x = torch.ones(1, 4, 6, 6)
    w = torch.ones(4, 2, 3, 3)
    tops.conv2d(x, w, groups=2)
    assert tops.conv_fallback_counts().get("groups", 0) >= 1
    raw = metrics.registry().label_counts("conv_fallback_total", "reason")
    assert raw.get("groups", 0) >= 1
    tops.reset_conv_fallbacks()
    assert tops.conv_fallback_counts() == {}


# --------------------------------------------------------------------------- #
# profiler                                                                     #
# --------------------------------------------------------------------------- #


def test_profile_plan_rows_match_steps():
    go, plan = _plan("super_resolution")
    x = _frame("super_resolution")[None]
    prof = profile_plan(plan, go.params, x, runs=2, warmup=1)
    assert prof.backend == "reference" and prof.device == "cpu"
    assert len(prof.steps) == len(plan.steps)
    assert prof.runs == 2
    assert prof.total_ms > 0
    assert sum(s.pct for s in prof.steps) == pytest.approx(100.0)
    for row, st in zip(prof.steps, plan.steps):
        assert row.name == st.node.name and row.op == st.node.op
        assert row.ms >= 0 and row.bytes_moved > 0
        assert row.attribution == "reference"
        assert row.out_shape
        # no device clock on the CPU: no device column, never a CPU number
        assert row.device_ms is None and row.device_pct is None
    assert prof.total_device_ms is None and "cpu" in prof.device_note
    text = prof.render_text(top=3)
    assert "plan profile" in text and text.count("\n") == 4  # header+head+3
    assert "n/a" in text and "host ms" in text and "dev ms" in text
    with pytest.raises(ValueError, match="no device times"):
        prof.render_text(by="device")
    blob = json.loads(json.dumps(prof.to_json()))
    assert blob["backend"] == "reference" and blob["total_device_ms"] is None
    assert [s["device_ms"] for s in blob["steps"]] == [None] * len(plan.steps)
    assert not trace.enabled()  # the caller's tracing state (off) is back


def test_profile_plan_trace_is_valid_chrome_trace(tmp_path):
    go, plan = _plan("coloring")
    prof = profile_plan(plan, go.params, _frame("coloring")[None], runs=1)
    p = prof.trace.save(str(tmp_path / "t.json"))
    doc = json.load(open(p))
    assert doc["displayTimeUnit"] == "ms"
    steps = [s for s in prof.trace.spans() if s["cat"] == "step"]
    assert len(steps) == len(plan.steps)


def test_profile_plan_guarded_has_a_device_note_and_demotions():
    go, plan = _plan("coloring", backend="guarded")
    with FaultPlan([FaultRule("conv2d", "raise", rate=1.0)]):
        prof = profile_plan(plan, go.params, _frame("coloring")[None], runs=1, warmup=0)
    assert prof.total_device_ms is None and prof.device_note
    demoted = [s for s in prof.steps if s.attribution == "demoted"]
    assert demoted and all(s.op == "conv2d" and s.demotions >= 1 for s in demoted)
    assert all(s.attribution in ("quant", "shared") for s in prof.steps if not s.demotions)
    with pytest.raises(ValueError):
        profile_plan(plan, go.params, _frame("coloring")[None], runs=0)


def _jax_plan(c, backend, quant):
    g = c["jgq"] if quant else c["jgo"]
    return jcompile_plan(g, backend=backend, interpret=backend != "reference"), g.params


@pytest.mark.parametrize("app", APPS)
@pytest.mark.parametrize("backend", ["reference", "kernel", "quant", "guarded"])
def test_profile_bytes_and_attribution_match_jax(app, backend):
    """The same plan (numpy-seeded weights, f32 graph; the INT8 graph for
    ``quant``) profiled by both packages: per step the same name, op, output
    shape, bytes moved and attribution."""
    quant = backend == "quant"
    c = quant_case(app) if quant else app_case(app)
    tg = c["tgq"] if quant else c["tgo"]
    jplan, jparams = _jax_plan(c, backend, quant)
    x = np.random.default_rng(3).standard_normal(
        (1, tcnn.APP_INPUT_CHANNELS[app], 8, 8)).astype(np.float32)
    want = jprofile_plan(jplan, jparams, jnp.asarray(x), runs=1, warmup=0)
    plan = compile_plan(tg, backend=backend, device="cpu")
    got = profile_plan(plan, tg.params, torch.from_numpy(x), runs=1, warmup=0)
    assert got.backend == want.backend == backend
    assert [(s.name, s.op) for s in got.steps] == [(s.name, s.op) for s in want.steps]
    assert [s.out_shape for s in got.steps] == [s.out_shape for s in want.steps]
    assert [s.bytes_moved for s in got.steps] == [s.bytes_moved for s in want.steps]
    assert [s.attribution for s in got.steps] == [s.attribution for s in want.steps]
    assert got.memory["param_bytes"] == want.memory["param_bytes"]
    assert got.memory["peak_activation_bytes"] == want.memory["peak_activation_bytes"]
    assert got.total_device_ms is None


# --------------------------------------------------------------------------- #
# the device clock, with stand-in CUDA events                                  #
# --------------------------------------------------------------------------- #


class _FakeCuda:
    """Stand-ins for ``torch.cuda.Event`` / ``_sleep`` / ``synchronize``: an
    event's time is its record order; ``query()`` answers from ``reached``
    (True: the card already passed the window's start)."""

    def __init__(self, reached):
        self.reached = list(reached)  # one answer per window check, in order
        self.clock = 0
        self.sleeps = []
        self.queries = 0

    def install(self, monkeypatch):
        fake = self

        class Event:
            def __init__(self, enable_timing=False):
                self.t = None

            def record(self):
                fake.clock += 1
                self.t = fake.clock

            def query(self):
                fake.queries += 1
                return fake.reached.pop(0) if fake.reached else False

            def elapsed_time(self, end):
                return float(end.t - self.t)

        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: fake.sleeps.append(cycles))
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def test_device_clock_windows_and_step_times(monkeypatch):
    fake = _FakeCuda([])
    fake.install(monkeypatch)
    dc = tprof._DeviceClock(n_inputs=2, n_steps=5, window=2, sleep_cycles=100)
    dc.open_window()
    dc("x", None)
    dc("y", None)  # graph inputs: no event
    for i in range(5):
        dc(f"s{i}", None)
    # windows [0, 1] [2, 3] [4]: a sleep + start event ahead of each
    assert len(dc.starts) == 3 and len(dc.events) == 5 and fake.sleeps == [100] * 3
    assert fake.queries == 3 and dc.ok
    # record order: start0=1 e0=2 e1=3 start1=4 e2=5 e3=6 start2=7 e4=8
    assert dc.step_ms() == [1.0, 1.0, 1.0, 1.0, 1.0]


def test_timed_run_retries_longer_then_in_windows_then_raises(monkeypatch):
    go, plan = _plan("coloring")
    x = _frame("coloring")[None]
    n = len(plan.steps)
    # the card reached a window's start in each of the first three tries
    fake = _FakeCuda([True, True, True, False])
    fake.install(monkeypatch)
    dc = tprof._timed_run(plan, go.params, (x,), n, host_call_ms=10.0, cycles_per_ms=1000.0)
    assert dc.window == n // 2 // 2 and dc.ok and len(dc.events) == n
    # sleeps: try 1 margin 2, try 2 margin 4, tries 3-4 halve the window
    assert fake.sleeps[0] == int((2 * 10.0 + 1.0) * 1000)
    assert fake.sleeps[1] == int((4 * 10.0 + 1.0) * 1000)
    fake2 = _FakeCuda([True] * 1000)
    fake2.install(monkeypatch)
    with pytest.raises(RuntimeError, match="caught up with the host.*step 'low1'"):
        tprof._timed_run(plan, go.params, (x,), n, 10.0, 1000.0)


# --------------------------------------------------------------------------- #
# serving wiring                                                               #
# --------------------------------------------------------------------------- #


def _sr_server(**kw):
    go, plan = _plan("super_resolution")
    server = AsyncPlanServer(clock=kw.pop("clock", lambda: 0.0), **kw)
    server.add_plan("sr", plan, go.params, batch_size=2)
    return server


def test_serving_trace_links_requests_to_exactly_one_batch():
    server = _sr_server()
    with trace.tracing() as buf:
        handles = [server.submit("sr", _frame("super_resolution", i)) for i in range(6)]
        while server.step():
            pass
        assert all(h.done() for h in handles)
        server.close()
    batch_spans = [s for s in buf.spans() if s["name"] == "batch"]
    assert len(batch_spans) == 3
    rid_to_batch = {}
    for s in batch_spans:
        for rid in s["args"]["rids"]:
            assert rid not in rid_to_batch
            rid_to_batch[rid] = s["args"]["batch"]
    assert sorted(rid_to_batch) == [h.rid for h in handles]
    for h in handles:
        mine = [e for e in buf.async_events("request") if e["id"] == str(h.rid)]
        assert [e["ph"] for e in mine] == ["b", "n", "e"]
        batched = [e for e in mine if e["ph"] == "n"][0]
        done = [e for e in mine if e["ph"] == "e"][0]
        assert batched["args"]["batch"] == rid_to_batch[h.rid]
        assert done["args"]["phase"] == "completed"
        assert done["args"]["deadline_missed"] is False


def test_serving_stats_mirrored_into_registry():
    server = _sr_server()
    for i in range(4):
        server.submit("sr", _frame("super_resolution", i))
    while server.step():
        pass
    server.close()
    events = metrics.registry().label_counts("serving_events_total", "plan", "event")
    assert events["sr/submitted"] == 4
    assert events["sr/completed"] == 4
    assert events["sr/batches"] == 2
    assert metrics.registry().histogram("serving_latency_seconds", plan="sr").count == 4
    assert metrics.registry().gauge("serving_queue_depth_peak", plan="sr").value == 4
    assert server.health()["plans"]["sr"]["queue_peak"] == 4


def test_shed_request_ends_its_trace_span():
    server = _sr_server(max_queue=1, overload="shed")
    with trace.tracing() as buf:
        h1 = server.submit("sr", _frame("super_resolution", 0))
        h2 = server.submit("sr", _frame("super_resolution", 1), priority=1)  # evicts h1
        evs = [e for e in buf.async_events("request") if e["id"] == str(h1.rid)]
        assert [e["ph"] for e in evs] == ["b", "e"]
        assert evs[-1]["args"]["phase"] == "shed"
        server.step(force=True)
        server.close()
    assert h2.done()


# --------------------------------------------------------------------------- #
# CLIs                                                                         #
# --------------------------------------------------------------------------- #


def test_profile_cli_writes_json_and_trace_on_cpu(tmp_path, capsys):
    tj, pj = tmp_path / "t.json", tmp_path / "p.json"
    prof = tprofile.main(["--graph-app", "coloring", "--device", "cpu", "--size", "16",
                          "--base", "8", "--runs", "1", "--top", "4",
                          "--trace-out", str(tj), "--json-out", str(pj)])
    out = capsys.readouterr().out
    assert "plan profile: backend=kernel device=cpu" in out and "memory:" in out
    doc = json.loads(pj.read_text())
    assert doc["backend"] == "kernel" and doc["total_device_ms"] is None
    assert len(doc["steps"]) == len(prof.steps) == 19
    assert all(s["device_ms"] is None for s in doc["steps"])
    steps = [e for e in json.loads(tj.read_text())["traceEvents"]
             if e.get("cat") == "step" and e["ph"] == "B"]
    assert len(steps) == 19
    assert sum(tops.kernel_launch_counts().values()) == 0  # plain versions on the CPU


def test_profile_cli_quantize_defaults_to_the_quant_backend(capsys):
    prof = tprofile.main(["--graph-app", "coloring", "--device", "cpu", "--size", "8",
                          "--base", "4", "--runs", "1", "--quantize"])
    assert prof.backend == "quant"
    assert {s.attribution for s in prof.steps} <= {"quant", "shared"}
    assert "quantize:" in capsys.readouterr().out


@pytest.mark.parametrize("mode", [["--graph-app", "coloring"], ["--async", "--graph-app",
                                                                 "coloring"]])
def test_serve_metrics_dump_writes_snapshots_and_trace(tmp_path, mode):
    path = tmp_path / "new_dir" / "m.json"  # the dump makes its directory
    tserve.main([*mode, "--size", "8", "--base", "4", "--frames", "3", "--device", "cpu",
                 "--metrics-dump", str(path), "--metrics-interval", "0.01"])
    snap = json.loads(path.read_text())
    assert snap["interval_s"] == 0.01 and len(snap["snapshots"]) >= 1
    assert all({"t", "metrics"} <= set(s) for s in snap["snapshots"])
    doc = json.loads((tmp_path / "new_dir" / "m.json.trace.json").read_text())
    plans = [e for e in doc["traceEvents"] if e.get("cat") == "plan" and e["ph"] == "B"]
    assert plans  # tracing was armed for the run
    assert not trace.enabled()  # and disarmed after it
