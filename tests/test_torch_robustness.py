"""The port's guarded execution, fault injection, circuit breakers and retry
helper against the JAX package's, on the CPU (mirroring
``tests/test_robustness.py`` where it applies).

The state machines are driven by the same scripts in both packages and
must step identically: breaker states, the seeded fault sequence per site,
the retry sleep schedule, the guarded plans' demotion counters.  The three
demo apps (base 8, 12x12 frames) run guarded: at 0% faults with no demotion
and ``torch.equal`` to the kernel plan (and within 1e-4 of the JAX
reference plan), at 100% ``torch.equal`` to the port's reference plan, at
a seeded 5% with demotions equal to injections.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import GraphBuilder as JGraphBuilder
from repro.core.graph import compile_plan as jcompile_plan
from repro.robustness import CircuitBreaker as JCircuitBreaker
from repro.robustness import FaultPlan as JFaultPlan
from repro.robustness import FaultRule as JFaultRule
from repro.robustness import GuardConfig as JGuardConfig
from repro.robustness import InjectedFault as JInjectedFault
from repro.utils.retry import retry_call as jretry_call
from repro_torch.core.graph import (
    EXEC_BACKENDS,
    GraphBuilder,
    PassContext,
    PassManager,
    compile_plan,
    guard_fallback_counts,
)
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.models import cnn as tcnn
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.quant import calibrate_plan
from repro_torch.robustness import (
    BreakerOpen,
    CircuitBreaker,
    FaultPlan,
    FaultRule,
    GuardConfig,
    InjectedFault,
    active_fault_plan,
    uninstall_all,
)
from repro_torch.robustness import faults as tfaults
from repro_torch.utils.retry import retry_call
from test_torch_plan import app_case

APPS = ["style_transfer", "coloring", "super_resolution"]
SIZE = 12


@pytest.fixture(autouse=True)
def _port_state():
    """The port's process-wide state around each test: installed fault
    plans (uninstalled), the metrics registry (guard demotion counters
    included), the tracing switch, and the tuning cache's entries, stats and
    switches (the JAX package's conftest fixture covers only its own)."""
    cache = tops.tuning_cache()
    snap = (dict(cache.entries), cache.enabled, cache.sweeps, cache.path, cache.ops_filter,
            {op: dict(s) for op, s in cache.stats.items()})
    reg = tmetrics.registry().dump_state()
    trace = ttrace.state()
    try:
        yield
    finally:
        tfaults.uninstall_all()
        tmetrics.registry().load_state(reg)
        ttrace.restore(trace)
        (cache.entries, cache.enabled, cache.sweeps, cache.path, cache.ops_filter,
         cache.stats) = (dict(snap[0]), *snap[1:5], {op: dict(s) for op, s in snap[5].items()})


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _w(n=8, seed=0):
    return np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)


def _tiny(backend="guarded", guard=None, n=8):
    """One-linear-layer graph: the smallest demotable plan (port, CPU)."""
    b = GraphBuilder(["x"])
    g = b.build(b.add("linear", "x", params={"w": torch.from_numpy(_w(n))}))
    return g, compile_plan(g, backend=backend, guard=guard, device="cpu")


def _jtiny(guard=None, n=8):
    b = JGraphBuilder(["x"])
    g = b.build(b.add("linear", "x", params={"w": jnp.asarray(_w(n))}))
    return g, jcompile_plan(g, backend="guarded", guard=guard)


def _x(rows=2, n=8, seed=1):
    return np.random.default_rng(seed).standard_normal((rows, n)).astype(np.float32)


# --------------------------------------------------------------------------- #
# circuit breaker: the same script, the same states                            #
# --------------------------------------------------------------------------- #

#: (threshold, window, cooldown) and a script of (op, arg): "f" record a
#: failure, "s" a success, "a" allow(), "t" advance the clock by arg
BREAKER_SCRIPTS = {
    "trip": ((3, 10.0, 5.0), "a f f a f a t1 a"),
    "window_prunes": ((3, 10.0, 5.0), "f f t11 f a f a f a"),
    "half_open": ((1, 30.0, 5.0), "f a t5 a f a t5 a s a"),
    "flap": ((2, 4.0, 2.0), "f t1 f a t2 a s f f a t3 a f t2 a s s a"),
}


def _breaker_trace(cls, params, script):
    clk = Clock()
    br = cls(threshold=params[0], window=params[1], cooldown=params[2], clock=clk)
    out = []
    for tok in script.split():
        if tok == "f":
            br.record_failure()
        elif tok == "s":
            br.record_success()
        elif tok == "a":
            out.append(("allow", br.allow()))
        else:
            clk.advance(float(tok[1:]))
        out.append((tok, br.snapshot()))
    return out


@pytest.mark.parametrize("name", list(BREAKER_SCRIPTS))
def test_breaker_state_sequence_matches_jax(name):
    params, script = BREAKER_SCRIPTS[name]
    got = _breaker_trace(CircuitBreaker, params, script)
    assert got == _breaker_trace(JCircuitBreaker, params, script)
    assert any(s["trips"] for _, s in got if isinstance(s, dict))


def test_breaker_raise_if_open_and_bad_threshold():
    clk = Clock()
    br = CircuitBreaker(threshold=1, cooldown=5.0, clock=clk)
    br.record_failure()
    with pytest.raises(BreakerOpen):
        br.raise_if_open()
    clk.advance(5.0)
    br.raise_if_open()  # half-open: the probe is allowed
    with pytest.raises(ValueError, match="threshold"):
        CircuitBreaker(threshold=0)


# --------------------------------------------------------------------------- #
# fault plans: the same seed and rules, the same injections                    #
# --------------------------------------------------------------------------- #

FAULT_CASES = {
    "raise30": ([("matmul", "raise", 0.3)], 7),
    "mixed": ([("conv*", "nan", 0.5), ("linear", "inf", 0.2), ("*", "raise", 0.1)], 3),
    "latency": ([("q*", "latency", 0.4), ("*", "raise", 0.05)], 11),
}
SITES = ["matmul", "conv2d", "linear", "qlinear", "qconv2d", "fused_elementwise"]


def _fault_trace(plan_cls, rule_cls, exc_cls, rules, seed):
    slept = []
    fp = plan_cls([rule_cls(s, k, rate=r, delay=0.25) for s, k, r in rules], seed=seed,
                  sleep=slept.append)
    fns = {s: fp.wrap(s, lambda: np.ones(3, np.float32)) for s in SITES}
    order = np.random.default_rng(seed).integers(0, len(SITES), 300)
    out = []
    for i in order:
        site = SITES[i]
        try:
            y = np.asarray(fns[site]())
            out.append((site, "nan" if np.isnan(y).all() else "inf" if np.isinf(y).all()
                        else "ok"))
        except exc_cls:
            out.append((site, "raise"))
    return out, slept, fp.injected, fp.calls, fp.injection_count()


class _NumpyPoison(FaultPlan):
    """The port's plan, poisoning numpy stand-ins: ``torch.full_like`` on a
    tensor view of the array (the poison under test is the port's)."""

    def _fire(self, site):
        post = super()._fire(site)
        return None if post is None else lambda y: post(torch.from_numpy(y)).numpy()


@pytest.mark.parametrize("case", list(FAULT_CASES))
def test_fault_plan_injection_sequence_matches_jax(case):
    rules, seed = FAULT_CASES[case]
    got = _fault_trace(_NumpyPoison, FaultRule, InjectedFault, rules, seed)
    want = _fault_trace(JFaultPlan, JFaultRule, JInjectedFault, rules, seed)
    assert got == want
    assert got[4] > 0  # faults actually fired


def test_fault_rule_validates_kind_and_rate():
    with pytest.raises(ValueError, match="kind"):
        FaultRule("matmul", "explode")
    with pytest.raises(ValueError, match="rate"):
        FaultRule("matmul", "raise", rate=1.5)


def test_install_patches_and_uninstall_restores_entry_points():
    orig = tops.matmul
    x = torch.ones(4, 4)
    with FaultPlan([FaultRule("matmul", "raise", rate=1.0)], seed=0) as fp:
        assert tops.matmul is not orig
        with pytest.raises(InjectedFault):
            tops.matmul(x, x)
        with pytest.raises(InjectedFault):  # col_matmul reaches matmul through the module
            tops.col_matmul(x, x, torch.arange(4, dtype=torch.int32))
        assert fp.injection_count("matmul") == 2
        assert active_fault_plan() is fp
    assert tops.matmul is orig and active_fault_plan() is None
    assert torch.equal(tops.matmul(x, x), torch.full((4, 4), 4.0))


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_poisoning_keeps_shape_dtype_and_device(kind):
    x = torch.ones(4, 4)
    with FaultPlan([FaultRule("matmul", kind, rate=1.0)], seed=0):
        y = tops.matmul(x, x)
    assert y.shape == (4, 4) and y.dtype == torch.float32 and y.device == x.device
    assert bool((torch.isnan(y) if kind == "nan" else torch.isinf(y)).all())


def test_latency_injection_uses_injectable_sleep():
    slept = []
    x = torch.ones(4, 4)
    with FaultPlan([FaultRule("matmul", "latency", rate=1.0, delay=0.25)], seed=0,
                   sleep=slept.append):
        y = tops.matmul(x, x)
    assert slept == [0.25] and torch.equal(y, torch.full((4, 4), 4.0))


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_cache_corrupt_picks_the_same_keys_as_jax(fraction):
    from repro.kernels import ops as jops

    keys = [f"matmul|{m}x64x64|float32|dense|cpu" for m in range(1, 17)]
    cache, jcache = tops.tuning_cache(), jops.tuning_cache()
    cache.entries.clear()  # both fixtures restore the caches afterwards
    jcache.entries.clear()
    for k in keys:
        cache.entries[k] = tops.TuneEntry((64, 64, 16, 1), "swept", 0.3)
        jcache.entries[k] = jops.TuneEntry((64, 128, 128), "swept", 0.3)
    with FaultPlan([FaultRule("*", "cache_corrupt", rate=fraction)], seed=5) as fp:
        with JFaultPlan([JFaultRule("*", "cache_corrupt", rate=fraction)], seed=5) as jfp:
            assert fp.corrupted_keys == jfp.corrupted_keys and fp.corrupted_keys
            assert all(cache.entries[k].blocks == (0, 0, 0, 0) for k in fp.corrupted_keys)
            assert fp.injection_count("tuning_cache") == len(fp.corrupted_keys)


def test_double_install_raises_and_uninstall_all_sweeps():
    fp1 = FaultPlan([FaultRule("matmul", "raise")]).install()
    fp2 = FaultPlan([FaultRule("conv2d", "raise")]).install()
    with pytest.raises(RuntimeError, match="already installed"):
        fp1.install()
    assert active_fault_plan() is fp2
    assert uninstall_all() == 2
    assert active_fault_plan() is None


# --------------------------------------------------------------------------- #
# retry helper                                                                 #
# --------------------------------------------------------------------------- #

RETRY_CASES = {
    "recovers": (3, dict(retries=5, backoff=1.0, backoff_factor=2.0, jitter=0.5)),
    "exhausts": (9, dict(retries=2, backoff=0.5, backoff_factor=3.0, jitter=0.0)),
    "first_try": (0, dict(retries=3, backoff=1.0, jitter=1.0)),
}


def _retry_trace(fn_retry, fails, kw):
    delays, attempts, calls = [], [], {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= fails:
            raise OSError("transient")
        return "ok"

    try:
        out = fn_retry(flaky, sleep=delays.append, rng=random.Random(0),
                       on_retry=lambda i, e: attempts.append(i), **kw)
    except OSError:
        out = "raised"
    return out, delays, attempts, calls["n"]


@pytest.mark.parametrize("case", list(RETRY_CASES))
def test_retry_call_schedule_matches_jax(case):
    fails, kw = RETRY_CASES[case]
    got = _retry_trace(retry_call, fails, kw)
    assert got == _retry_trace(jretry_call, fails, kw)
    for d, base in zip(got[1], [kw["backoff"] * kw.get("backoff_factor", 2.0) ** i
                                for i in range(len(got[1]))]):
        assert base <= d <= base * (1 + kw["jitter"])


def test_retry_call_validates():
    with pytest.raises(ValueError, match="retries"):
        retry_call(lambda: 1, retries=-1)
    with pytest.raises(ValueError, match="jitter"):
        retry_call(lambda: 1, jitter=-0.1)


# --------------------------------------------------------------------------- #
# the guarded executor                                                         #
# --------------------------------------------------------------------------- #


def test_guarded_backend_is_listed_and_validated():
    assert "guarded" in EXEC_BACKENDS
    g, _ = _tiny(backend="reference")
    with pytest.raises(ValueError, match="guarded"):
        compile_plan(g, backend="bogus", device="cpu")
    with pytest.raises(ValueError, match="guard"):
        compile_plan(g, backend="reference", guard=GuardConfig(), device="cpu")


#: rules and calls for the tiny guarded plan, both packages
TINY_CASES = {
    "none": ([], 3),
    "raise_all": ([("linear", "raise", 1.0)], 6),
    "nan_all": ([("linear", "nan", 1.0)], 2),
    "inf_half": ([("*", "inf", 0.5)], 12),
    "raise_30": ([("linear", "raise", 0.3)], 20),
}


@pytest.mark.parametrize("case", list(TINY_CASES))
def test_guarded_tiny_plan_steps_like_jax(case):
    """The same seeded faults over the same calls: the same outputs (within
    1e-5), the same demotion counters and breaker states, and every output
    finite (demoted steps ran the reference handler)."""
    rules, calls = TINY_CASES[case]
    clk, jclk = Clock(), Clock()
    g, plan = _tiny(guard=GuardConfig(breaker_threshold=3, breaker_cooldown=2.0, clock=clk))
    jg, jplan = _jtiny(guard=JGuardConfig(breaker_threshold=3, breaker_cooldown=2.0,
                                          clock=jclk))
    ref = compile_plan(g, backend="reference", device="cpu")
    x = _x()
    with FaultPlan([FaultRule(*r) for r in rules], seed=4) as fp, \
            JFaultPlan([JFaultRule(*r) for r in rules], seed=4) as jfp:
        for i in range(calls):
            y = plan(g.params, torch.from_numpy(x))
            jy = jplan(jg.params, jnp.asarray(x))
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
            assert bool(torch.isfinite(y).all())
            assert plan.guard_stats() == jplan.guard_stats(), i
            if plan.guard_stats()["counters"]["fallbacks"] == i + 1:  # every call demoted
                assert torch.equal(y, ref(g.params, torch.from_numpy(x)))
            clk.advance(0.5)
            jclk.advance(0.5)
        assert fp.injection_count() == jfp.injection_count()
    c = plan.guard_stats()["counters"]
    assert c["primary_ok"] + c["fallbacks"] == calls
    assert sum(guard_fallback_counts().values()) == c["fallbacks"]


def test_numeric_guard_can_be_disabled():
    g, plan = _tiny(guard=GuardConfig(numeric_guards=False))
    with FaultPlan([FaultRule("linear", "nan", rate=1.0)], seed=0):
        y = plan(g.params, torch.ones(2, 8))
    assert bool(torch.isnan(y).all())  # poison flows through, no demotion
    assert plan.guard_stats()["counters"]["fallbacks"] == 0


def test_breaker_pins_to_reference_then_recovers_after_cooldown():
    clk = Clock()
    g, plan = _tiny(guard=GuardConfig(breaker_threshold=2, breaker_cooldown=5.0, clock=clk))
    ref = compile_plan(g, backend="reference", device="cpu")
    x = torch.from_numpy(_x())
    with FaultPlan([FaultRule("linear", "raise", rate=1.0)], seed=0):
        plan(g.params, x)
        plan(g.params, x)  # failure 2 -> breaker opens
        assert plan.guard_stats()["breakers"]["linear/f32"]["state"] == "open"
        plan(g.params, x)  # short-circuits: no primary attempt
    assert plan.guard_stats()["counters"]["breaker_short_circuits"] == 1
    assert torch.equal(plan(g.params, x), ref(g.params, x))  # still pinned
    clk.advance(5.0)
    plan(g.params, x)  # half-open probe runs the healthy kernel -> closed
    assert plan.guard_stats()["breakers"]["linear/f32"] == {
        "state": "closed", "trips": 1, "recent_failures": 0}


@pytest.mark.parametrize("scheme", ["w8", "w8a8"])
def test_qlinear_scheme_keys_breakers_separately(scheme):
    """A quantized node's breaker key carries its scheme, as in the JAX
    package, so a broken INT8 kernel never opens the f32 family's."""
    kw = dict(format="dense", scheme=scheme)
    if scheme == "w8a8":
        kw["x_scale"] = 0.05
    vals = np.ones((8, 8), np.int8)
    scale = np.full((8,), 0.1, np.float32)
    b = GraphBuilder(["x"])
    g = b.build(b.add("qlinear", "x", params={"values": torch.from_numpy(vals),
                                              "w_scale": torch.from_numpy(scale)}, **kw))
    jb = JGraphBuilder(["x"])
    jg = jb.build(jb.add("qlinear", "x", params={"values": jnp.asarray(vals),
                                                 "w_scale": jnp.asarray(scale)}, **kw))
    plan = compile_plan(g, backend="guarded", device="cpu")
    jplan = jcompile_plan(jg, backend="guarded")
    with FaultPlan([FaultRule("qlinear", "raise")], seed=0), \
            JFaultPlan([JFaultRule("qlinear", "raise")], seed=0):
        y = plan(g.params, torch.ones(2, 8))
        jy = jplan(jg.params, jnp.ones((2, 8), jnp.float32))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    assert plan.guard_stats()["counters"]["by_key"] == {f"qlinear/{scheme}/exception": 1}
    assert plan.guard_stats() == jplan.guard_stats()


def test_corrupted_tuning_cache_raises_unguarded_and_demotes_guarded():
    """cache_corrupt chaos: a zero tile raises TileError before any launch;
    the kernel plan propagates it, the guarded plan demotes the step and
    returns the reference plan's bits."""
    g, plan = _tiny(n=16)
    kplan = compile_plan(g, backend="kernel", device="cpu")
    ref = compile_plan(g, backend="reference", device="cpu")
    x = torch.from_numpy(_x(4, 16))
    kplan(g.params, x)  # records the default entry of this key
    with FaultPlan([FaultRule("*", "cache_corrupt", rate=1.0)], seed=0) as fp:
        assert fp.corrupted_keys
        with pytest.raises(_build.TileError):
            kplan(g.params, x)
        y = plan(g.params, x)
    assert torch.equal(y, ref(g.params, x))
    assert plan.guard_stats()["counters"]["by_key"] == {"linear/f32/exception": 1}


def test_batched_guarded_plan_is_eager_and_pads():
    g, plan = _tiny()
    with pytest.raises(NotImplementedError, match="via_vmap"):
        plan.batched(2, via_vmap=True)
    bp = plan.batched(2)
    with FaultPlan([FaultRule("linear", "raise", rate=1.0)], seed=0):
        y = bp(g.params, torch.ones(3, 8))  # padded tail chunk
    assert y.shape == (3, 8)
    assert plan.guard_stats()["counters"]["fallbacks"] == 2  # two chunks


def test_demotions_surface_in_registry_and_trace():
    g, plan = _tiny()
    with FaultPlan([FaultRule("linear", "raise", rate=1.0)], seed=0):
        with ttrace.tracing() as buf:
            plan(g.params, torch.from_numpy(_x()))
    assert guard_fallback_counts()["linear/f32/exception"] == 1
    series = tmetrics.registry().counter(
        "guard_demotions_total", op="linear", scheme="f32", reason="exception")
    assert series.value == 1
    (step,) = [s for s in buf.spans() if s["cat"] == "step"]
    assert step["args"]["demoted"] == "exception"
    (inst,) = buf.instants("guard")
    assert inst["name"] == "demote:linear"
    assert inst["args"] == {"scheme": "f32", "reason": "exception"}
    assert step["ts"] <= inst["ts"] <= step["ts"] + step["dur"]


def test_reference_handler_errors_propagate():
    """A demoted step whose reference handler fails too raises: nothing
    hides a broken device behind the fallback."""
    g, plan = _tiny()
    with FaultPlan([FaultRule("linear", "raise", rate=1.0)], seed=0):
        with pytest.raises(RuntimeError):
            plan(g.params, torch.ones(2, 5))  # wrong width: both handlers fail


# --------------------------------------------------------------------------- #
# the three demo apps, guarded                                                 #
# --------------------------------------------------------------------------- #


def _frames(app, n, seed=3):
    c = tcnn.APP_INPUT_CHANNELS[app]
    return np.random.default_rng(seed).standard_normal((n, c, SIZE, SIZE)).astype(np.float32)


_INT8 = {}


def _graph(app, precision):
    """The port's optimized f32 graph of ``app`` (numpy params shared with
    the JAX package), or its INT8 graph: calibrated on the port's reference
    plan over two batches and quantized with the app's skip sets."""
    go = app_case(app)["tgo"]
    if precision == "f32":
        return go
    if app not in _INT8:
        ref = compile_plan(go, backend="reference", device="cpu")
        table = calibrate_plan(ref, go.params,
                               [torch.from_numpy(_frames(app, 2, seed=s)) for s in (7, 8)])
        _INT8[app] = PassManager(("quantize",)).run(go, PassContext(
            calibration=table, quant_skip=tcnn.APP_QUANT_SKIP[app],
            act_quant_skip=tcnn.APP_ACT_SKIP[app]))
    return _INT8[app]


def _demotable(plan):
    """Steps whose primary handler differs from the reference one."""
    refs = plan._ref_handlers
    return sum(1 for s in plan.steps
               if s.node.op in refs and plan._handlers.get(s.node.op, refs[s.node.op])
               is not refs[s.node.op])


@pytest.mark.parametrize("precision", ["f32", "int8"])
@pytest.mark.parametrize("app", APPS)
def test_guarded_app_at_total_faults_equals_reference_plan(app, precision):
    go = _graph(app, precision)
    plan = compile_plan(go, backend="guarded", device="cpu")
    ref = compile_plan(go, backend="reference", device="cpu")
    x = torch.from_numpy(_frames(app, 2))
    with FaultPlan([FaultRule("*", "raise", rate=1.0)], seed=7):
        y = plan(go.params, x)
    assert torch.equal(y, ref(go.params, x))
    c = plan.guard_stats()["counters"]
    assert c["primary_ok"] == 0 and c["fallbacks"] == _demotable(plan) > 0


@pytest.mark.parametrize("precision", ["f32", "int8"])
@pytest.mark.parametrize("app", APPS)
def test_guarded_app_without_faults_equals_kernel_plan(app, precision):
    go = _graph(app, precision)
    plan = compile_plan(go, backend="guarded", device="cpu")
    kplan = compile_plan(go, backend="quant" if precision == "int8" else "kernel", device="cpu")
    x = torch.from_numpy(_frames(app, 2))
    y = plan(go.params, x)
    assert torch.equal(y, kplan(go.params, x))
    c = plan.guard_stats()["counters"]
    assert c["fallbacks"] == 0 and c["primary_ok"] == _demotable(plan)
    if precision == "f32":  # and the JAX reference plan's numbers
        want = app_case(app)["jrun"](app_case(app)["jgo"].params, jnp.asarray(x.numpy()))
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("app", APPS)
def test_guarded_app_at_5pct_demotes_exactly_the_injections(app):
    go = _graph(app, "f32")
    plan = compile_plan(go, backend="guarded", guard=GuardConfig(breaker_threshold=100),
                        device="cpu")
    ref = compile_plan(go, backend="reference", device="cpu")
    with FaultPlan([FaultRule("*", "raise", rate=0.05)], seed=7) as fp:
        for i in range(6):
            x = torch.from_numpy(_frames(app, 2, seed=10 + i))
            y, want = plan(go.params, x), ref(go.params, x)
            tol = 1e-3 * max(1.0, float(want.abs().max()))
            assert float((y - want).abs().max()) <= tol
    c = plan.guard_stats()["counters"]
    assert fp.injection_count() >= 1
    assert c["fallbacks"] == fp.injection_count()
    assert c["primary_ok"] + c["fallbacks"] == 6 * _demotable(plan)


@pytest.mark.parametrize("fault", ["none", "raise_all", "nan_5pct"])
def test_guarded_decode_plans_keep_greedy_tokens(fault):
    """The smoke decoder's guarded plans through ``submit_llm``: the kernel
    plans' tokens at 0% faults (no demotion), the reference plans' at 100%,
    and the same at a seeded 5% NaN rate; no sequence fails, no page
    leaks."""
    from repro_torch.configs import smoke_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.core.graph.passes import optimize
    from repro_torch.models.transformer_graph import build_decoder_graph, decoder_cache_spec
    from repro_torch.serving import AsyncPlanServer, PagedKVCache
    from test_torch_decode import numpy_lm

    cfg = smoke_config("qwen2.5-3b")
    params = lm_params_from_numpy(numpy_lm(cfg, seed=1), device="cpu")
    graphs = {ph: optimize(build_decoder_graph(params, cfg, phase=ph))
              for ph in ("prefill", "decode")}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (4, 6, 3)]

    def serve(backend):
        plans = {ph: compile_plan(g, backend=backend, device="cpu",
                                  guard=GuardConfig(breaker_threshold=100)
                                  if backend == "guarded" else None)
                 for ph, g in graphs.items()}
        cache = PagedKVCache(num_pages=32, page_size=4, **decoder_cache_spec(cfg))
        server = AsyncPlanServer()
        server.add_llm("lm", prefill=plans["prefill"], decode=plans["decode"], cache=cache,
                       max_batch=2)
        hs = [server.submit_llm("lm", p, max_new_tokens=3) for p in prompts]
        while any(not h.done() for h in hs):
            server.step()
        st = server.stats["per_llm"]["lm"]
        server.close()
        cache.check_invariants()
        assert st["failed"] == 0 and cache.used_pages == 0
        demoted = sum(p.guard_stats().get("counters", {}).get("fallbacks", 0)
                      for p in plans.values())
        return [[int(t) for t in h.result(0)] for h in hs], demoted

    rules = {"none": [], "raise_all": [FaultRule("*", "raise", rate=1.0)],
             "nan_5pct": [FaultRule("*", "nan", rate=0.05)]}[fault]
    with FaultPlan(rules, seed=7) as fp:
        got, demoted = serve("guarded")
    assert demoted == fp.injection_count()
    if fault == "none":
        assert demoted == 0 and got == serve("kernel")[0]
    else:
        assert demoted > 0 and got == serve("reference")[0]
