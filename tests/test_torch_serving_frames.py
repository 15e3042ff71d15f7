"""The frame side of the port's ``AsyncPlanServer`` against the JAX
package's, on the CPU (mirroring ``tests/test_serving.py`` and the serving
part of ``tests/test_robustness.py``).

Each scenario is one script of ``submit`` / ``step`` / clock moves written
once against the shared API and run on both packages' servers with the same
numpy frames and a fake clock: every submit's verdict, the handles done
after each tick (batch membership), latencies, the completion order, the
``stats`` counters and the ``health()`` snapshot must be equal, and the
outputs within 1e-4 at unit scale, 1e-4 of the largest value beyond it
(hot swaps double every weight).  The port serves its kernel-backend plan,
the JAX package its reference plan; apps at base 8 with 12x12 frames.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.robustness as jrobustness
import repro.serving as jserving
import repro_torch.robustness as trobustness
import repro_torch.serving as tserving
from repro.core.graph import GraphBuilder as JGraphBuilder
from repro.core.graph import compile_plan as jcompile_plan
from repro_torch.core.graph import GraphBuilder, compile_plan
from repro_torch.models import cnn as tcnn
from test_torch_plan import app_case
from test_torch_robustness import _port_state  # noqa: F401 (autouse fixture)

SIZE = 12


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _np_frame(app, i, dtype=np.float32, shape=None):
    shape = shape or (tcnn.APP_INPUT_CHANNELS[app], SIZE, SIZE)
    return np.random.default_rng(100 + i).standard_normal(shape).astype(dtype)


_PLANS = {}


class Side:
    """One package's serving API, plans and frames, as the scenarios see
    them: ``S.serving`` / ``S.robustness`` are the package modules, ``S.plan
    (app)`` its ``(plan, params)`` for an app (the port's kernel plan on the
    CPU, the JAX package's reference plan), ``S.tiny()`` a guarded
    one-linear plan, ``S.frame(...)`` a frame of the package's array
    type."""

    def __init__(self, name):
        self.name = name
        jax_side = name == "jax"
        self.serving = jserving if jax_side else tserving
        self.robustness = jrobustness if jax_side else trobustness
        self.arr = jnp.asarray if jax_side else torch.from_numpy

    def plan(self, app):
        key = (self.name, app)
        if key not in _PLANS:
            c = app_case(app)
            if self.name == "jax":
                _PLANS[key] = (c["jplan"], c["jgo"].params)
            else:
                _PLANS[key] = (compile_plan(c["tgo"], backend="kernel", device="cpu"),
                               c["tgo"].params)
        return _PLANS[key]

    def tiny(self):
        w = np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32)
        if self.name == "jax":
            b = JGraphBuilder(["x"])
            g = b.build(b.add("linear", "x", params={"w": jnp.asarray(w)}))
            return jcompile_plan(g, backend="guarded"), g.params
        b = GraphBuilder(["x"])
        g = b.build(b.add("linear", "x", params={"w": torch.from_numpy(w)}))
        return compile_plan(g, backend="guarded", device="cpu"), g.params

    def frame(self, app, i, dtype=np.float32, shape=None):
        return self.arr(_np_frame(app, i, dtype, shape))

    def scaled(self, params, factor):
        """Float leaves times ``factor`` (sparse formats carry indices)."""
        def f(v):
            a = np.asarray(v)
            return self.arr((a * factor).astype(a.dtype)) if a.dtype.kind == "f" else v
        return {n: {k: f(v) for k, v in p.items()} for n, p in params.items()}

    def spec_dtype(self):
        return jnp.float32 if self.name == "jax" else torch.float32


class Rec:
    """What a scenario observed, in order, plus each completed output."""

    def __init__(self):
        self.events = []
        self.outs = {}

    def __call__(self, *ev):
        self.events.append(ev)

    def call(self, label, fn, *args, **kw):
        try:
            out = fn(*args, **kw)
        except Exception as e:  # the verdict is what is compared
            self.events.append((label, type(e).__name__))
            return None
        self.events.append((label, "ok"))
        return out

    def done(self, handles):
        self.events.append(("done", [h.done() for h in handles]))

    def verdicts(self, handles):
        for h in handles:
            err = h.exception()
            self.events.append(("verdict", h.rid, h.tenant, None if err is None
                                else type(err).__name__, h.latency, h.deadline_missed))
            if h.done() and err is None:
                self.outs[h.rid] = np.asarray(h.result(0))


# --------------------------------------------------------------------------- #
# scenarios (test_serving.py, test_robustness.py's serving part)               #
# --------------------------------------------------------------------------- #


def sc_full_batch_executes(S, rec):
    plan, params = S.plan("super_resolution")
    srv = S.serving.AsyncPlanServer(clock=lambda: 0.0)
    srv.add_plan("sr", plan, params, batch_size=4)
    hs = [srv.submit("sr", S.frame("super_resolution", i)) for i in range(4)]
    rec.done(hs)
    rec("pending", srv.pending("sr"))
    rec("step", srv.step())
    rec.done(hs)
    rec.verdicts(hs)
    rec("stats", srv.stats)
    srv.close()


def sc_flush_after_partial_batch(S, rec):
    plan, params = S.plan("super_resolution")
    clk = Clock()
    srv = S.serving.AsyncPlanServer(clock=clk, flush_after=1.0)
    srv.add_plan("sr", plan, params, batch_size=4)
    h = srv.submit("sr", S.frame("super_resolution", 0))
    for t in (0.0, 0.99, 1.0):
        clk.t = t
        rec("step", t, srv.step(), h.done())
    rec.verdicts([h])
    rec("stats", srv.stats)
    srv.close()


def sc_deadline_with_empty_queue(S, rec):
    plan, params = S.plan("super_resolution")
    srv = S.serving.AsyncPlanServer(clock=Clock(100.0), flush_after=0.5)
    srv.add_plan("sr", plan, params, batch_size=4)
    rec("step", srv.step(), srv.step(force=True))
    rec("stats", srv.stats)
    srv.close()


def sc_request_deadline_and_miss(S, rec):
    plan, params = S.plan("super_resolution")
    clk = Clock()
    srv = S.serving.AsyncPlanServer(clock=clk)
    srv.add_plan("sr", plan, params, batch_size=4)
    slack = srv.submit("sr", S.frame("super_resolution", 0))
    rec("step", srv.step())
    h = srv.submit("sr", S.frame("super_resolution", 1), deadline=0.5)
    rec("step", srv.step())
    clk.t = 0.6
    rec("step", srv.step())
    rec.verdicts([slack, h])
    rec("stats", srv.stats)
    srv.close()


def sc_priority_classes(S, rec):
    plan, params = S.plan("super_resolution")
    srv = S.serving.AsyncPlanServer(clock=lambda: 0.0)
    srv.add_plan("sr", plan, params, batch_size=4)
    lo = [srv.submit("sr", S.frame("super_resolution", i), priority=0) for i in range(4)]
    hi = [srv.submit("sr", S.frame("super_resolution", i), priority=1) for i in range(4, 6)]
    rec("step", srv.step())
    rec.done(lo + hi)
    rec("step", srv.step(force=True))
    rec.verdicts(lo + hi)
    rec("drained", [h.rid for h in srv.drain_completed()])
    srv.close()


def sc_validation_errors(S, rec):
    plan, params = S.plan("super_resolution")
    srv = S.serving.AsyncPlanServer(clock=lambda: 0.0)
    srv.add_plan("sr", plan, params, batch_size=4)
    f = S.frame("super_resolution", 0)
    rec.call("unknown_plan", srv.submit, "nope", f)
    rec.call("arity", srv.submit, "sr", f, f)
    rec.call("duplicate", srv.add_plan, "sr", plan, params, 4)
    rec.call("tenant", srv.submit, "sr", f, tenant="nope")
    rec.call("spec_len", srv.add_plan, "sr2", plan, params, 4,
             input_spec=[((3, SIZE, SIZE), S.spec_dtype())] * 2)
    srv.close()
    rec.call("closed_submit", srv.submit, "sr", f)
    rec.call("closed_start", srv.start)
    rec.call("closed_add", srv.add_plan, "sr3", plan, params, 4)


def sc_reject_policy(S, rec):
    plan, params = S.plan("super_resolution")
    srv = S.serving.AsyncPlanServer(clock=lambda: 0.0, max_queue=2, overload="reject")
    srv.add_plan("sr", plan, params, batch_size=4)
    hs = [rec.call(f"submit{i}", srv.submit, "sr", S.frame("super_resolution", i))
          for i in range(3)]
    rec("pending", srv.pending("sr"), srv.stats["rejected"])
    rec("drained_by_close", srv.close())
    rec.verdicts([h for h in hs if h is not None])


def sc_shed_policy(S, rec):
    plan, params = S.plan("super_resolution")
    srv = S.serving.AsyncPlanServer(clock=lambda: 0.0, max_queue=2, overload="shed")
    srv.add_plan("sr", plan, params, batch_size=4)
    f = [S.frame("super_resolution", i) for i in range(6)]
    hs = [rec.call("hi", srv.submit, "sr", f[0], priority=1),
          rec.call("a", srv.submit, "sr", f[1], priority=0),
          rec.call("newcomer", srv.submit, "sr", f[2], priority=0),
          rec.call("evicts", srv.submit, "sr", f[3], priority=2),
          rec.call("low", srv.submit, "sr", f[4], priority=0)]
    hs = [h for h in hs if h is not None]
    rec.done(hs)
    rec("stats", srv.stats)
    srv.close()
    rec.verdicts(hs)


def sc_due_deadline_wins_membership(S, rec):
    plan, params = S.plan("super_resolution")
    clk = Clock()
    srv = S.serving.AsyncPlanServer(clock=clk)
    srv.add_plan("sr", plan, params, batch_size=4)
    low = srv.submit("sr", S.frame("super_resolution", 0), priority=0, deadline=0.5)
    hi = [srv.submit("sr", S.frame("super_resolution", i), priority=1) for i in range(1, 7)]
    clk.t = 0.6
    rec("step", srv.step())
    rec.done([low] + hi)
    srv.close()
    rec.verdicts([low] + hi)


def sc_multi_plan_routing_and_fairness(S, rec):
    sr, col = S.plan("super_resolution"), S.plan("coloring")
    srv = S.serving.AsyncPlanServer(clock=lambda: 0.0)
    srv.add_plan("heavy", *sr, batch_size=2)
    srv.add_plan("light", *col, batch_size=2)
    rec("plans", srv.plans)
    heavy = [srv.submit("heavy", S.frame("super_resolution", i)) for i in range(8)]
    light = [srv.submit("light", S.frame("coloring", i)) for i in range(2)]
    while not all(h.done() for h in light):
        rec("step", srv.step())
        rec.done(heavy + light)
    srv.close()
    rec.verdicts(heavy + light)
    rec("drained", [h.rid for h in srv.drain_completed()])
    rec("stats", srv.stats)


def sc_bad_frames_fail_at_submit(S, rec):
    plan, params = S.plan("super_resolution")
    srv = S.serving.AsyncPlanServer(clock=lambda: 0.0)
    srv.add_plan("sr", plan, params, batch_size=4)
    ok = srv.submit("sr", S.frame("super_resolution", 0))  # latches the spec
    rec.call("shape", srv.submit, "sr", S.frame("super_resolution", 1, shape=(3, 4, 4)))
    rec.call("dtype", srv.submit, "sr", S.frame("super_resolution", 2, dtype=np.int32))
    rec("step", srv.step(force=True))
    rec.verdicts([ok])
    rec("stats", srv.stats)
    srv.add_plan("sr_spec", plan, params, batch_size=4,
                 input_spec=[((3, SIZE, SIZE), S.spec_dtype())])
    rec.call("first_bad", srv.submit, "sr_spec", S.frame("super_resolution", 3,
                                                          shape=(3, 4, 4)))
    h = srv.submit("sr_spec", S.frame("super_resolution", 4))
    rec("step", srv.step(force=True))
    rec.verdicts([h])
    srv.close()


def sc_result_timeout_and_latency(S, rec):
    plan, params = S.plan("super_resolution")
    srv = S.serving.AsyncPlanServer(clock=lambda: 0.0)
    srv.add_plan("sr", plan, params, batch_size=4)
    h = srv.submit("sr", S.frame("super_resolution", 0))
    rec.call("result", h.result, 0)
    rec("before", h.exception(), h.latency)
    srv.close()
    rec.verdicts([h])


def sc_health_of_a_guarded_plan_under_faults(S, rec):
    plan, params = S.tiny()
    srv = S.serving.AsyncPlanServer(clock=lambda: 0.0)
    srv.add_plan("tiny", plan, params, batch_size=2)
    x = S.arr(np.ones(8, np.float32))
    with S.robustness.FaultPlan([S.robustness.FaultRule("linear", "raise", rate=1.0)], seed=0):
        h = srv.submit("tiny", x)
        rec("step", srv.step(force=True))
    rec.verdicts([h])
    rec("health", srv.health())
    srv.close()


def sc_submit_with_retry_rides_out_backpressure(S, rec):
    plan, params = S.tiny()
    srv = S.serving.AsyncPlanServer(clock=lambda: 0.0, max_queue=1)
    srv.add_plan("tiny", plan, params, batch_size=2)
    x = S.arr(np.ones(8, np.float32))
    h1 = srv.submit("tiny", x)
    sleeps = []

    def sleep(dt):
        sleeps.append(dt > 0)
        srv.step(force=True)

    h2 = S.serving.submit_with_retry(srv, "tiny", x, retries=3, backoff=0.001, sleep=sleep)
    srv.step(force=True)
    rec.verdicts([h1, h2])
    rec("sleeps", sleeps)
    srv.submit("tiny", x)
    rec.call("exhausted", S.serving.submit_with_retry, srv, "tiny", x, retries=2,
             backoff=0.001, sleep=lambda _: None)
    rec("stats", srv.stats)
    srv.close()


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_full_batch_executes, sc_flush_after_partial_batch, sc_deadline_with_empty_queue,
    sc_request_deadline_and_miss, sc_priority_classes, sc_validation_errors,
    sc_reject_policy, sc_shed_policy, sc_due_deadline_wins_membership,
    sc_multi_plan_routing_and_fairness, sc_bad_frames_fail_at_submit,
    sc_result_timeout_and_latency, sc_health_of_a_guarded_plan_under_faults,
    sc_submit_with_retry_rides_out_backpressure,
)}


def run_both(scenario):
    """Run ``scenario`` on both packages; assert they observed the same
    events and outputs within 1e-4; return the port's record."""
    recs = {}
    for name in ("jax", "torch"):
        recs[name] = Rec()
        scenario(Side(name), recs[name])
    got, want = recs["torch"], recs["jax"]
    assert got.events == want.events
    assert sorted(got.outs) == sorted(want.outs)
    for rid, y in got.outs.items():  # 1e-4 at unit scale, relative beyond it
        w = want.outs[rid]
        np.testing.assert_allclose(y, w, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(w).max())))
    return got


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_frame_scheduler_steps_like_jax(name):
    rec = run_both(SCENARIOS[name])
    assert rec.events


def test_full_batch_output_equals_the_plan_on_that_batch():
    """A served output is the plan's own output on the batch the scheduler
    formed, bit for bit (the port's plan, not the JAX package's)."""
    S = Side("torch")
    plan, params = S.plan("super_resolution")
    srv = S.serving.AsyncPlanServer(clock=lambda: 0.0)
    srv.add_plan("sr", plan, params, batch_size=4)
    frames = [S.frame("super_resolution", i) for i in range(4)]
    hs = [srv.submit("sr", f) for f in frames]
    assert srv.step() == 1
    want = plan(params, torch.stack(frames))
    for i, h in enumerate(hs):
        assert torch.equal(h.result(0), want[i])
    srv.close()


def test_numpy_frames_and_numpy_dtypes_in_the_spec():
    """Frames may arrive as numpy arrays; an input spec may name numpy
    dtypes: both are carried as torch's."""
    S = Side("torch")
    plan, params = S.plan("coloring")
    srv = S.serving.AsyncPlanServer(clock=lambda: 0.0)
    srv.add_plan("c", plan, params, batch_size=2, input_spec=[((1, SIZE, SIZE), np.float32)])
    f = _np_frame("coloring", 0)
    h = srv.submit("c", f)
    with pytest.raises(tserving.FrameSpecError):
        srv.submit("c", f.astype(np.float64))
    srv.step(force=True)
    assert torch.equal(h.result(0), plan(params, torch.from_numpy(f)[None])[0])
    srv.close()


# --------------------------------------------------------------------------- #
# threads: watchdog, tick errors, close under load (port only)                 #
# --------------------------------------------------------------------------- #


def test_watchdog_fails_the_slow_batch_only():
    """A latency fault (a host sleep inside the step) outlasts the watchdog:
    that batch's handles fail with WatchdogTimeout, a late finish never
    overwrites the verdict, and the next batch completes."""
    S = Side("torch")
    plan, params = S.tiny()
    srv = S.serving.AsyncPlanServer(watchdog=0.1)
    srv.add_plan("tiny", plan, params, batch_size=2)
    x = torch.ones(8)
    h0 = srv.submit("tiny", x)
    srv.step(force=True)
    assert h0.result(5).shape == (8,)
    release = threading.Event()
    fp = trobustness.FaultPlan([trobustness.FaultRule("linear", "latency", rate=1.0)], seed=0,
                               sleep=lambda _: release.wait(10)).install()
    try:
        h = srv.submit("tiny", x)
        srv.step(force=True)
        assert isinstance(h.exception(), tserving.WatchdogTimeout)
        assert srv.stats["per_plan"]["tiny"]["watchdog_timeouts"] == 1
    finally:
        release.set()
        fp.uninstall()
    time.sleep(0.05)
    assert isinstance(h.exception(), tserving.WatchdogTimeout)
    h2 = srv.submit("tiny", x)
    srv.step(force=True)
    assert h2.exception() is None and h2.result(1).shape == (8,)
    srv.close()


def test_scheduler_thread_survives_tick_errors():
    S = Side("torch")
    plan, params = S.tiny()
    srv = S.serving.AsyncPlanServer(tick_interval=0.001, flush_after=0.005)
    srv.add_plan("tiny", plan, params, batch_size=2)
    boom = {"n": 0}
    real_step = srv.step

    def bad_step(**kw):
        if boom["n"] < 3:
            boom["n"] += 1
            raise RuntimeError("injected tick failure")
        return real_step(**kw)

    srv.step = bad_step
    srv.start()
    deadline = time.monotonic() + 5
    while boom["n"] < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert boom["n"] == 3 and srv.running
    assert srv.health()["tick_errors"] == 3
    del srv.step
    h = srv.submit("tiny", torch.ones(8))
    assert h.result(5).shape == (8,)
    srv.close()
    assert not srv.running


def test_close_under_inflight_requests_and_background_drain():
    S = Side("torch")
    plan, params = S.plan("super_resolution")
    srv = S.serving.AsyncPlanServer(flush_after=0.005, tick_interval=0.001)
    srv.add_plan("sr", plan, params, batch_size=4)
    srv.start()
    hs = [srv.submit("sr", S.frame("super_resolution", i)) for i in range(11)]
    for h in hs[:4]:
        h.result(30)
    srv.close()
    assert not srv.running and srv.closed
    assert all(h.done() and h.exception() is None for h in hs)
    assert srv.stats["completed"] == 11
    assert sorted(h.rid for h in srv.drain_completed()) == [h.rid for h in hs]
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit("sr", S.frame("super_resolution", 0))


def test_latency_stats_and_registry_mirrors():
    from repro_torch.obs import metrics as tmetrics

    S = Side("torch")
    plan, params = S.plan("super_resolution")
    clk = Clock()
    srv = S.serving.AsyncPlanServer(clock=clk)
    srv.add_plan("sr", plan, params, batch_size=2)
    hs = [srv.submit("sr", S.frame("super_resolution", i)) for i in range(4)]
    clk.t = 0.25
    srv.step()
    clk.t = 0.5
    srv.step()
    lat = srv.latency_stats("sr")
    assert lat["count"] == 4 and lat["p50"] == pytest.approx(0.375)
    assert srv.latency_stats() == lat
    reg = tmetrics.registry()
    assert reg.counter("serving_events_total", plan="sr", event="completed").value == 4
    assert reg.histogram("serving_latency_seconds", plan="sr").count == 4
    assert [h.latency for h in hs] == [0.25, 0.25, 0.5, 0.5]
    srv.close()
