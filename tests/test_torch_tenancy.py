"""Multi-tenant serving in the port (``serving/tenancy.py``,
``serving/rollout.py`` and the scheduler's tenant wiring) against the JAX
package's, on the CPU (mirroring ``tests/test_tenancy.py``).

Token buckets, deficit round-robin and the SLO ladder are driven by the
same scripts on a fake clock in both packages and must produce the same
traces; quotas, weighted fair share, the ladder's rungs and versioned hot
swap run as scripted server scenarios on both (see
``test_torch_serving_frames.run_both``).
"""

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_fallback import given, settings, st

from repro.serving import DeficitRoundRobin as JDeficitRoundRobin
from repro.serving import LadderConfig as JLadderConfig
from repro.serving import Tenant as JTenant
from repro.serving import TenantSLO as JTenantSLO
from repro.serving import TokenBucket as JTokenBucket
from repro_torch.obs import metrics as tmetrics
from repro_torch.serving import (
    DeficitRoundRobin,
    LadderConfig,
    Tenant,
    TenantSLO,
    TokenBucket,
)
from test_torch_robustness import _port_state  # noqa: F401 (autouse fixture)
from test_torch_serving_frames import Clock, run_both

# --------------------------------------------------------------------------- #
# units: the same script, the same trace                                       #
# --------------------------------------------------------------------------- #

BUCKET_SCRIPTS = {
    "burst_then_refill": ((10.0, 3.0), [0, 0, 0, 0, 0.05, 0.1, 100, 100, 100, 100]),
    "slow_rate": ((0.5, None), [0, 0, 1, 2, 2, 4, 4.1, 9]),
    "floored_burst": ((1.0, 0.01), [0, 0, 0.5, 1.0, 1.0]),
    "unlimited": ((None, None), [0, 0, 0, 1e9]),
}


@pytest.mark.parametrize("name", list(BUCKET_SCRIPTS))
def test_token_bucket_trace_matches_jax(name):
    (rate, burst), times = BUCKET_SCRIPTS[name]
    b, jb = TokenBucket(rate, burst), JTokenBucket(rate, burst)
    got = [(b.take(t), b.tokens) for t in times]
    assert got == [(jb.take(t), jb.tokens) for t in times]
    assert b.burst == jb.burst


def test_token_bucket_validation():
    with pytest.raises(ValueError, match="rate"):
        TokenBucket(0.0)
    assert TokenBucket(1.0, burst=0.01).burst == 1.0


#: (weights, slots per round, rounds, per-round arrivals per tenant)
DRR_CASES = {
    "3_to_1": ({"a": 3.0, "b": 1.0}, 4, 16, {"a": 8, "b": 8}),
    "tiny_weight": ({"a": 1.0, "b": 0.05}, 4, 40, {"a": 8, "b": 8}),
    "idle_then_busy": ({"a": 1.0, "b": 1.0, "c": 2.5}, 3, 12, {"a": 4, "b": 0, "c": 1}),
    "fractional": ({"x": 0.7, "y": 1.3, "z": 2.2}, 5, 20, {"x": 3, "y": 2, "z": 4}),
}


def _drr_trace(cls, weights, slots, rounds, arrivals):
    drr = cls()
    queues = {n: [] for n in weights}
    out = []
    for r in range(rounds):
        for n, k in arrivals.items():
            queues[n] += [(n, r, i) for i in range(k)]
        out.append(drr.select(queues, weights, slots))
        out.append(dict(drr.deficits))
    return out


@pytest.mark.parametrize("name", list(DRR_CASES))
def test_drr_selection_trace_matches_jax(name):
    case = DRR_CASES[name]
    got = _drr_trace(DeficitRoundRobin, *case)
    assert got == _drr_trace(JDeficitRoundRobin, *case)
    picked = [x for sel in got[0::2] for x in sel]
    assert {n for n, _, _ in picked} == {n for n, k in case[3].items() if k}  # none starves


#: latency windows fed to one tenant, then an evaluation each
LADDER_SCRIPTS = {
    "escalate_recover": ((0.01, None, 2), (2, 3), [1.0] * 5 + [0.001] * 4),
    "miss_rate": ((None, 0.25, 2), (1, 2), ["miss"] * 4 + [0.001] * 5),
    "undersized": ((0.01, None, 8), (1, 1), ["one"] * 3 + [1.0] * 3),
}


def _ladder_trace(tenant_cls, slo_cls, cfg_cls, slo_args, cfg_args, windows):
    t = tenant_cls("t", slo=slo_cls(p99_latency=slo_args[0], max_miss_rate=slo_args[1],
                                     min_samples=slo_args[2]),
                   ladder=cfg_cls(breach_evals=cfg_args[0], recover_evals=cfg_args[1]))
    out = []
    for w in windows:
        if w == "one":
            t.observe(1.0, missed=True)
        else:
            for _ in range(4):
                t.observe(0.001 if w == "miss" else w, missed=w == "miss")
        out.append((t.evaluate(), t.level_name, t.breach_streak, t.ok_streak,
                    t.window_completed))
    return out, dict(t.stats)


@pytest.mark.parametrize("name", list(LADDER_SCRIPTS))
def test_ladder_trace_matches_jax(name):
    got = _ladder_trace(Tenant, TenantSLO, LadderConfig, *LADDER_SCRIPTS[name])
    assert got == _ladder_trace(JTenant, JTenantSLO, JLadderConfig, *LADDER_SCRIPTS[name])
    if name != "undersized":
        assert got[1]["ladder_up"] >= 1


def test_ladder_config_and_tenant_validation():
    with pytest.raises(ValueError, match="shrink_factor"):
        LadderConfig(shrink_factor=0.0)
    with pytest.raises(ValueError, match="evals"):
        LadderConfig(breach_evals=0)
    with pytest.raises(ValueError, match="weight"):
        Tenant("t", weight=0.0)


@settings(max_examples=12, deadline=None)
@given(
    w_hot=st.floats(1.0, 8.0),
    hot_per_round=st.integers(4, 12),
    light_per_round=st.integers(1, 4),
)
def test_fair_share_property_matches_jax(w_hot, hot_per_round, light_per_round):
    """Any skew and weight: both packages pick the same members round by
    round, and the light tenant never starves."""
    weights = {"hot": w_hot, "light": 1.0}
    arrivals = {"hot": hot_per_round, "light": light_per_round}
    got = _drr_trace(DeficitRoundRobin, weights, 4, 32, arrivals)
    assert got == _drr_trace(JDeficitRoundRobin, weights, 4, 32, arrivals)
    done = [n for sel in got[0::2] for n, _, _ in sel]
    assert len(done) == 4 * 32 and done.count("light") >= 1


# --------------------------------------------------------------------------- #
# server scenarios, both packages                                              #
# --------------------------------------------------------------------------- #


def sc_quota_throttles_and_refills(S, rec):
    plan, params = S.plan("super_resolution")
    clk = Clock()
    srv = S.serving.AsyncPlanServer(clock=clk)
    srv.add_plan("sr", plan, params, batch_size=4)
    srv.add_tenant("metered", rate=10.0, burst=2.0)
    f = S.frame("super_resolution", 0)
    for i in range(3):
        rec.call(f"submit{i}", srv.submit, "sr", f, tenant="metered")
    clk.t = 0.1
    rec.call("refilled", srv.submit, "sr", f, tenant="metered")

    def sleep(dt):
        clk.t += max(dt, 0.1)

    h = S.serving.submit_with_retry(srv, "sr", f, tenant="metered", backoff=0.1, sleep=sleep)
    rec("retried", h.tenant, clk.t > 0.1)
    rec("stats", srv.stats)
    srv.close()


def sc_weighted_fair_share(S, rec):
    plan, params = S.plan("super_resolution")
    srv = S.serving.AsyncPlanServer(clock=lambda: 0.0)
    srv.add_plan("sr", plan, params, batch_size=4)
    srv.add_tenant("gold", weight=3.0)
    srv.add_tenant("free", weight=1.0)
    rec("tenants", srv.tenants)
    hs = [srv.submit("sr", S.frame("super_resolution", i), tenant="gold") for i in range(8)]
    hs += [srv.submit("sr", S.frame("super_resolution", i), tenant="free") for i in range(8, 16)]
    for _ in range(4):
        rec("step", srv.step())
        rec("batch", [h.tenant for h in srv.drain_completed()])
    rec.verdicts(hs)
    rec("stats", srv.stats)
    srv.close()


def _breach_once(S, srv, clk, rec, latency=1.0, n=4):
    hs = [srv.submit("sr", S.frame("super_resolution", i), priority=1, tenant="t")
          for i in range(n)]
    clk.t += latency
    rec("full", srv.step())
    rec.verdicts(hs)
    clk.t += 10.0  # past the next evaluation
    rec("eval", srv.step())
    rec("level", srv.health()["tenants"]["t"])


def sc_ladder_shrinks_flush_then_demotes_then_sheds(S, rec):
    plan, params = S.plan("super_resolution")
    clk = Clock()
    srv = S.serving.AsyncPlanServer(clock=clk, flush_after=1.0)
    srv.add_plan("sr", plan, params, batch_size=4)
    srv.add_tenant("t", slo=S.serving.TenantSLO(p99_latency=0.01, min_samples=2),
                   ladder=S.serving.LadderConfig(interval=1.0, breach_evals=1,
                                                 recover_evals=2, shrink_factor=0.25,
                                                 shed_below_priority=1))
    srv.register_variant("sr", "cheap", plan, params)
    srv.step()  # arms the first evaluation
    for rung in range(3):
        _breach_once(S, srv, clk, rec)
        rec.call("low_prio", srv.submit, "sr", S.frame("super_resolution", 9),
                 priority=0, tenant="t")
        h = srv.submit("sr", S.frame("super_resolution", 10), priority=1, tenant="t")
        rec("runner", h._runner.label())
        clk.t += 0.26
        rec("shrunk_flush", srv.step(), h.done())
        srv.step(force=True)
        rec.verdicts([h])
    for _ in range(3):
        _breach_once(S, srv, clk, rec, latency=0.0)
    rec("health", srv.health())
    rec("stats", srv.stats)
    srv.close()


def sc_swap_zero_loss_and_retire(S, rec):
    plan, params = S.plan("super_resolution")
    srv = S.serving.AsyncPlanServer(clock=lambda: 0.0)
    srv.add_plan("sr", plan, params, batch_size=4)
    old = [srv.submit("sr", S.frame("super_resolution", i)) for i in range(2)]
    rec("v", srv.swap_plan("sr", plan, S.scaled(params, 2.0),
                           probe_frames=[S.frame("super_resolution", 0)]))
    rec("health", srv.health()["plans"]["sr"])
    new = [srv.submit("sr", S.frame("super_resolution", i)) for i in range(2, 6)]
    rec("runners", [h._runner.label() for h in old + new])
    while srv.step(force=True):
        pass
    rec.verdicts(old + new)
    rec("health_after", srv.health()["plans"]["sr"])
    rec("stats", srv.stats)
    srv.close()


def sc_swap_failed_probe_rolls_back(S, rec):
    plan, params = S.plan("super_resolution")
    srv = S.serving.AsyncPlanServer(clock=lambda: 0.0)
    srv.add_plan("sr", plan, params, batch_size=4)
    h = srv.submit("sr", S.frame("super_resolution", 0))
    rec.call("poisoned", srv.swap_plan, "sr", plan, S.scaled(params, np.nan))
    rec.call("drifting", srv.swap_plan, "sr", plan, S.scaled(params, 2.0),
             probe_frames=[S.frame("super_resolution", 1)], parity_tol=1e-6)
    rec.call("within_tol", srv.swap_plan, "sr", plan, params,
             probe_frames=[S.frame("super_resolution", 1)], parity_tol=1e-6)
    srv.step(force=True)
    rec.verdicts([h])
    rec("health", srv.health()["plans"]["sr"])
    rec("stats", srv.stats)
    srv.close()


def sc_swap_probe_needs_a_spec_or_frames(S, rec):
    plan, params = S.plan("super_resolution")
    srv = S.serving.AsyncPlanServer(clock=lambda: 0.0)
    srv.add_plan("sr", plan, params, batch_size=4)
    rec.call("unprobed", srv.swap_plan, "sr", plan, params)
    srv.add_plan("spec", plan, params, batch_size=4,
                 input_spec=[((3, 12, 12), S.spec_dtype())])
    rec("zeros_probe", srv.swap_plan("spec", plan, params))
    rec.call("unknown", srv.swap_plan, "nope", plan, params)
    rec("stats", srv.stats)
    srv.close()


def sc_register_variant_rules(S, rec):
    plan, params = S.plan("super_resolution")
    srv = S.serving.AsyncPlanServer(clock=lambda: 0.0)
    srv.add_plan("sr", plan, params, batch_size=4)
    rec.call("first", srv.register_variant, "sr", "cheap", plan, params)
    rec.call("duplicate", srv.register_variant, "sr", "cheap", plan, params)
    rec.call("primary", srv.register_variant, "sr", "primary", plan, params)
    rec.call("unknown", srv.register_variant, "nope", "cheap", plan, params)
    rec("health", srv.health()["plans"]["sr"])
    srv.close()


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_quota_throttles_and_refills, sc_weighted_fair_share,
    sc_ladder_shrinks_flush_then_demotes_then_sheds, sc_swap_zero_loss_and_retire,
    sc_swap_failed_probe_rolls_back, sc_swap_probe_needs_a_spec_or_frames,
    sc_register_variant_rules,
)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tenancy_scenario_steps_like_jax(name):
    rec = run_both(SCENARIOS[name])
    assert rec.events


def test_ladder_and_swap_metrics_in_the_port_registry():
    """The ladder's transitions and the swaps land in the port's registry
    (``serving_ladder_*``, ``serving_swap_total``)."""
    from test_torch_serving_frames import Rec, Side

    reg = tmetrics.registry()
    sc_ladder_shrinks_flush_then_demotes_then_sheds(Side("torch"), Rec())
    moves = reg.label_counts("serving_ladder_transitions_total", "tenant", "direction")
    assert moves.get("t/up") == 3.0 and moves.get("t/down") == 1.0
    assert reg.gauge("serving_ladder_level", tenant="t").value == 2
    sc_swap_zero_loss_and_retire(Side("torch"), Rec())
    assert reg.label_counts("serving_swap_total", "plan", "event") == {
        "sr/installed": 1.0, "sr/retired": 1.0}


def test_submit_with_retry_delegates_to_shared_retry_call(monkeypatch):
    import repro_torch.serving.scheduler as sched

    calls = {}

    def fake_retry_call(fn, **kw):
        calls.update(kw)
        return "handle"

    monkeypatch.setattr(sched, "retry_call", fake_retry_call)
    out = sched.submit_with_retry(object(), "sr", retries=7, backoff=0.25, jitter=0.0)
    assert out == "handle"
    assert calls["retries"] == 7 and calls["backoff"] == 0.25
    assert calls["retry_on"] == (sched.QueueFullError,)
