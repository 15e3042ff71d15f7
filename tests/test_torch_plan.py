"""The port's execution plans, batched serving, ``PlanServer`` and serve CLI
against the JAX package's, app by app, on the CPU.

Both sides get the same graph params and frames, drawn from a numpy seed.
The port's kernel-backend plan (plain kernel versions on the CPU) and its
reference-backend plan are held to the JAX reference plan at rtol = atol =
1e-4, the tolerance the JAX package holds its own kernel plan to
(``tests/test_fusion.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import PassContext as JPassContext
from repro.core.graph import PassManager as JPassManager
from repro.core.graph import compile_plan as jcompile_plan
from repro.models import cnn as jcnn
from repro.serving.engine import PlanServer as JPlanServer
from repro_torch.core.graph import PassContext, PassManager, compile_plan
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import cnn as tcnn
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.serving import PlanServer

APPS = ["style_transfer", "coloring", "super_resolution"]
BASE = 8
SIZE = 16
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _port_registry():
    """Restore the port's own metrics registry around each test."""
    snap = tmetrics.registry().dump_state()
    try:
        yield
    finally:
        tmetrics.registry().load_state(snap)


def numpy_params(g, seed=1):
    rng = np.random.default_rng(seed)
    out = {}
    for node in g.nodes:
        for key, v in g.params.get(node.name, {}).items():
            shape = tuple(v.shape)
            if key == "w":
                fan = int(np.prod(shape[1:])) if len(shape) == 4 else shape[0]
                arr = rng.standard_normal(shape) / np.sqrt(fan)
            elif key in ("scale", "var"):
                arr = rng.uniform(0.5, 1.5, shape)
            else:
                arr = rng.standard_normal(shape) * 0.1
            out.setdefault(node.name, {})[key] = arr.astype(np.float32)
    return out


_CACHE = {}


def app_case(app):
    """Both packages' optimized graphs of ``app`` over the same numpy params,
    plus the JAX reference plan (built once per app per test process; the
    JAX app's own weight draws are stubbed, their values are replaced)."""
    if app not in _CACHE:
        normal = jax.random.normal
        jax.random.normal = lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype)
        try:
            jg = jcnn.APPS[app](jax.random.PRNGKey(0), base=BASE)
        finally:
            jax.random.normal = normal
        pnp = numpy_params(jg)
        jg = dataclasses.replace(
            jg, params={n: {k: jnp.asarray(v) for k, v in p.items()} for n, p in pnp.items()}
        )
        jmasks, jstructs = jcnn.app_masks(jg, app, sparsity=0.5)
        jgo = JPassManager().run(jg, JPassContext(masks=jmasks, structures=jstructs))
        tg = tcnn.APPS[app](base=BASE, params=pnp, device="cpu")
        masks, structs = tcnn.app_masks(tg, app, sparsity=0.5)
        tgo = PassManager().run(tg, PassContext(masks=masks, structures=structs))
        jplan = jcompile_plan(jgo, backend="reference")
        _CACHE[app] = dict(jgo=jgo, jplan=jplan, jrun=jax.jit(jplan), tgo=tgo)
    return _CACHE[app]


def frames(app, n, seed=2):
    c = tcnn.APP_INPUT_CHANNELS[app]
    return np.random.default_rng(seed).standard_normal((n, c, SIZE, SIZE)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("app", APPS)
@pytest.mark.parametrize("backend", ["kernel", "reference"])
def test_plan_matches_jax_reference_plan(app, backend):
    c = app_case(app)
    x = frames(app, 2)
    want = c["jrun"](c["jgo"].params, jnp.asarray(x))
    plan = compile_plan(c["tgo"], backend=backend, device="cpu")
    assert len(plan.steps) == len(c["jplan"].steps)
    assert [s.frees for s in plan.steps] == [s.frees for s in c["jplan"].steps]
    got = plan(c["tgo"].params, torch.from_numpy(x))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_traced_plan_run_has_one_span_per_step():
    c = app_case("coloring")
    plan = compile_plan(c["tgo"], backend="kernel", device="cpu")
    x = torch.from_numpy(frames("coloring", 1))
    with ttrace.tracing() as buf:
        traced = plan(c["tgo"].params, x)
    spans = buf.spans()
    steps = [s for s in spans if s["cat"] == "step"]
    assert [s["name"] for s in steps] == [s.node.name for s in plan.steps]
    assert sum(s["cat"] == "plan" for s in spans) == 1
    assert steps[-1]["args"]["out_shape"] == list(traced.shape)
    np.testing.assert_array_equal(traced.numpy(), plan(c["tgo"].params, x).numpy())


@pytest.mark.parametrize("app", APPS)
def test_memory_estimate_matches_jax(app):
    c = app_case(app)
    shape = (2, tcnn.APP_INPUT_CHANNELS[app], SIZE, SIZE)
    want = c["jplan"].memory_estimate(jax.ShapeDtypeStruct(shape, jnp.float32))
    got = compile_plan(c["tgo"], backend="kernel", device="cpu").memory_estimate(shape)
    assert got["peak_activation_bytes"] == want["peak_activation_bytes"]
    assert got["param_bytes"] == want["param_bytes"]
    assert got["param_bytes_by_dtype"] == want["param_bytes_by_dtype"]
    assert [s[:2] for s in got["per_step"]] == [s[:2] for s in want["per_step"]]


@pytest.mark.parametrize("app", APPS)
def test_batched_plan_pads_the_tail(app):
    c = app_case(app)
    plan = compile_plan(c["tgo"], backend="kernel", device="cpu")
    x = torch.from_numpy(frames(app, 5))
    bp = plan.batched(2)
    got = bp(c["tgo"].params, x)
    assert bp.last_stats == {"frames": 5, "batches": 3, "padded_frames": 1}
    assert bp.total_stats == {"frames": 5, "batches": 3, "padded_frames": 1}
    want = plan(c["tgo"].params, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError):
        plan.batched(2, via_vmap=True)


@pytest.mark.parametrize("app", APPS)
def test_plan_server_matches_jax_plan_server(app):
    c = app_case(app)
    xs = frames(app, 6, seed=3)
    jsrv = JPlanServer(c["jplan"], c["jgo"].params, 4)
    tsrv = PlanServer(compile_plan(c["tgo"], backend="kernel", device="cpu"),
                      c["tgo"].params, 4, name=app)
    for x in xs[:5]:
        assert jsrv.submit(jnp.asarray(x)) == tsrv.submit(torch.from_numpy(x))
    assert tsrv.pending == jsrv.pending == 5
    _close(tsrv.flush(), jsrv.flush())
    jsrv.submit(jnp.asarray(xs[5]))
    tsrv.submit(torch.from_numpy(xs[5]))
    _close(tsrv.close(), jsrv.close())
    assert tsrv.stats == jsrv.stats
    assert tsrv.closed and tsrv.close() is None
    with pytest.raises(RuntimeError):
        tsrv.submit(torch.from_numpy(xs[0]))
    counts = tmetrics.registry().label_counts("serving_v1_events_total", "plan", "event")
    assert counts[f"{app}/frames"] == 6 and counts[f"{app}/padded_frames"] == 6


def test_plan_server_flush_after_deadline():
    c = app_case("super_resolution")
    now = [0.0]
    srv = PlanServer(compile_plan(c["tgo"], backend="kernel", device="cpu"), c["tgo"].params,
                     4, flush_after=0.5, clock=lambda: now[0])
    xs = frames("super_resolution", 3)
    srv.submit(xs[0])
    assert srv.poll() is None and srv.pending == 1
    now[0] = 0.6
    srv.submit(xs[1])  # the oldest frame is past its deadline: auto-flush
    assert srv.pending == 0 and srv.stats["deadline_flushes"] == 1
    (out,) = srv.drain_completed()
    assert out.shape[0] == 2 and srv.completed == []
    srv.submit(xs[2])
    now[0] = 1.2
    assert srv.poll().shape[0] == 1


@pytest.mark.parametrize("app", APPS)
def test_serve_cli_runs_in_process_on_cpu(app, capsys):
    tops.reset_kernel_launches()
    report = tserve.main([
        "--graph-app", app, "--size", str(SIZE), "--base", str(BASE), "--frames", "5",
        "--batch-size", "2", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "fuse_epilogue" in out and "plan: backend=kernel device=cpu" in out
    assert report["frames"] == 5 and report["device"] == "cpu"
    assert report["steps"] == {"style_transfer": 18, "coloring": 19, "super_resolution": 20}[app]
    assert report["frames_per_s"] > 0
    # the CPU runs the plain versions: no CUDA kernel was launched
    assert sum(tops.kernel_launch_counts().values()) == 0
    latency = tserve.main(["--graph-app", app, "--size", "8", "--base", str(BASE),
                           "--frames", "2", "--device", "cpu"])
    assert latency["ms_per_frame"] > 0
