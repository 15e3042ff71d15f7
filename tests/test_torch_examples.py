"""The port's twins of the JAX package's four ``examples/*.py`` scripts
(``repro_torch.examples``), on the CPU.

Each twin's stages are held to the JAX package's functions on the same
numpy arrays, and each twin runs end to end as a subprocess with ``--device
cpu``, printing the markers the JAX package's ``tests/test_examples.py``
asserts.  What is held, and why each tolerance:

* quickstart: the teacher projection, the ADMM run's hard-prune masks, the
  storage stage (kept-block map, balance, ``ReorderPlan`` and its bands,
  permuted weight, PBCSR payload, bytes) bit-equal; the ADMM params within
  rtol 1e-5 of JAX's after 30 steps with 3 Z/U updates (the same f32 ops
  summed in another order); the block-sparse product's plain route within
  1e-4 of JAX's Pallas ``bsr_matmul`` in interpret mode;
* prune_style_transfer: op histogram, plan steps, param bytes and peak
  activation bytes equal to JAX's ``bench_app`` quantities on the same
  params; the compiled plan within 1e-3 x max(1, max|ref|) of JAX's
  reference plan and of the port's pruned output; the FLOP counts within
  ``FLOP_RTOL`` of XLA's cost analysis and the FLOP cut within
  ``FLOP_CUT_RTOL`` (the flop counter counts each convolution as the GEMM
  of its padded patches and no elementwise op, XLA counts its own way:
  measured 1.7% above XLA on the unpruned graph, 0.6% on the compiled one,
  the cut 1.1% apart);
* serve_pruned_lm: the pruned leaves, their masks and pruned weights
  bit-equal; the ``Engine``'s greedy tokens equal to JAX's up to the first
  near-tie (a top-2 margin of the JAX logits below ``TIE``);
* train_lm_100m ``--tiny --prune``: the first 5 steps' ``ce`` within 1e-4
  of JAX's step on the same params and batches, the same hard-prune
  sparsity.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.core import pruning as jpr
from repro.core.graph import compile_plan as jcompile_plan
from repro.core.graph import lower as jlower
from repro.core.graph import optimize as jopt
from repro.core.sparse import PBCSR as JPBCSR
from repro.core.sparse import apply_column_perm as japply_perm
from repro.core.sparse import balance_stats as jbalance
from repro.core.sparse import block_mask as jblock_mask
from repro.core.sparse import plan_reorder as jplan_reorder
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.kernels import bsr_matmul as jbsr_matmul
from repro.launch.train import default_prune_plan as jdefault_plan
from repro.models import cnn as jcnn
from repro.models import get_model as jget_model
from repro.serving.engine import Engine as JEngine
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.train_loop import TrainState as JTrainState
from repro.training.train_loop import init_train_state as jinit_state
from repro.training.train_loop import make_train_step as jmake_step
from repro.utils.jax_compat import cost_analysis
from repro_torch.convert import lm_params_from_numpy
from repro_torch.examples import prune_style_transfer as tst
from repro_torch.examples import quickstart as tqs
from repro_torch.examples import serve_pruned_lm as tserve
from repro_torch.examples import train_lm_100m as ttrain
from repro_torch.models import cnn as tcnn
from repro_torch.models import get_model
from repro_torch.serving.engine import Engine
from repro_torch.utils.tree import leaves_with_path
from test_torch_decode import _tree_map, numpy_lm
from test_torch_plan import numpy_params

ROOT = Path(__file__).resolve().parents[1]
FLOP_RTOL = 0.03
FLOP_CUT_RTOL = 0.02
TIE = 1e-4


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _eq(got, want):
    g, w = _np(got), np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------- #
# quickstart                                                                   #
# --------------------------------------------------------------------------- #

QS_STEPS = 30  # 3 Z/U updates


def _jax_admm(w0, x, y, steps):
    """The JAX script's ADMM loop (``examples/quickstart.py:35-47``)."""
    plan = jpr.PrunePlan.from_rules([("*", jpr.Block(0.5, bm=64, bn=64))], min_size=16)
    cfg = jpr.AdmmConfig(**tqs.ADMM)
    params = {"w": w0}
    state = jpr.admm_init(params, plan, cfg)

    def task_loss(p):
        return jnp.mean((x @ p["w"] - y) ** 2)

    step = jax.jit(lambda p, s: jax.tree.map(
        lambda a, g: a - 2e-2 * g, p,
        jax.grad(lambda p_: task_loss(p_) + jpr.admm_penalty(p_, s))(p)))
    for it in range(steps):
        params = step(params, state)
        if it % 10 == 9:
            state = jpr.admm_update(params, state, cfg)
    pruned, masks = jpr.hard_prune(params, state)
    return params, pruned, masks


@pytest.fixture(scope="module")
def qs():
    a = tqs.make_problem()
    jteacher, _ = jpr.project(jnp.asarray(a["raw"]), jpr.Block(0.5, bm=64, bn=64))
    y = np.array(jnp.asarray(a["x"]) @ jteacher)
    jparams, jpruned, jmasks = _jax_admm(jnp.asarray(a["w0"]), jnp.asarray(a["x"]),
                                         jnp.asarray(y), QS_STEPS)
    return dict(a=a, y=y, jteacher=jteacher, jparams=jparams, jpruned=jpruned, jmasks=jmasks)


def test_quickstart_admm_stage_matches_jax(qs):
    a = qs["a"]
    _eq(tqs.teacher_of(torch.from_numpy(a["raw"])), qs["jteacher"])
    pr = tqs.admm_prune(torch.from_numpy(a["w0"]), torch.from_numpy(a["x"]),
                        torch.from_numpy(qs["y"]), steps=QS_STEPS)
    want = np.asarray(qs["jparams"]["w"])
    np.testing.assert_allclose(_np(pr["params"]["w"]), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    _eq(pr["mask"], qs["jmasks"]["w"])
    np.testing.assert_allclose(_np(pr["w"]), np.asarray(qs["jpruned"]["w"]), rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _storage_case(qs, name):
    """(w, mask) numpy: the JAX ADMM run's hard prune, or an unbalanced
    block mask (several bands, pads and an empty block-column)."""
    if name == "admm":
        return np.array(qs["jpruned"]["w"]), np.array(qs["jmasks"]["w"])
    rng = np.random.default_rng(9)
    w = rng.standard_normal((tqs.D, tqs.D)).astype(np.float32)
    w[:, 64:128] *= 1e-3  # this block-column loses every block
    wp, m = jpr.project(jnp.asarray(w), jpr.Block(0.6, bm=64, bn=64, balanced=False))
    return np.array(wp), np.array(m)


def _jax_storage(w, m):
    bmask = np.asarray(jblock_mask(jnp.asarray(m), 64, 64))
    rplan = jplan_reorder(bmask, max_bands=3, bm=64, bn=64)
    w_perm = japply_perm(jnp.asarray(w), rplan.order, 64)
    m_perm = japply_perm(jnp.asarray(m), rplan.order, 64)
    return dict(bmask=bmask, balance=jbalance(bmask), plan=rplan, w_perm=w_perm,
                fmt=JPBCSR.from_dense(w_perm, m_perm, 64, 64),
                bands=[(b.start, b.stop, b.count) for b in rplan.bands])


@pytest.mark.parametrize("name", ["admm", "unbalanced"])
def test_quickstart_storage_and_bsr_match_jax(qs, name):
    w, m = _storage_case(qs, name)
    got = tqs.compile_storage(torch.from_numpy(w), torch.from_numpy(m))
    want = _jax_storage(w, m)
    _eq(got["bmask"], want["bmask"])
    assert got["balance"] == want["balance"]
    np.testing.assert_array_equal(got["plan"].order, want["plan"].order)
    assert [dataclasses.astuple(b) for b in got["plan"].bands] == [
        (b.start, b.stop, b.count) for b in want["plan"].bands]
    assert got["bands"] == want["bands"]
    assert (got["plan"].waste_before, got["plan"].waste_after) == (
        want["plan"].waste_before, want["plan"].waste_after)
    _eq(got["w_perm"], want["w_perm"])
    fmt, jfmt = got["fmt"], want["fmt"]
    _eq(fmt.values, jfmt.values)
    _eq(fmt.block_rows, jfmt.block_rows)
    assert (fmt.n_blocks, fmt.padded_blocks, fmt.nbytes) == (
        jfmt.n_blocks, jfmt.padded_blocks, jfmt.nbytes)
    if name == "unbalanced":
        assert len(got["bands"]) > 1 and fmt.padded_blocks > 0
    # the block-sparse product: plain route vs JAX's Pallas kernel (interpret)
    x = qs["a"]["x"][: tqs.M_KERNEL]
    run = tqs.run_bsr(torch.from_numpy(x), fmt, got["bands"], got["w_perm"])
    jgot = jbsr_matmul(jnp.asarray(x), jfmt.values, jfmt.block_rows, bands=want["bands"],
                       interpret=True)
    np.testing.assert_allclose(_np(run["got"]), np.asarray(jgot), rtol=1e-4, atol=1e-4)
    assert run["max_err"] <= 1e-4 * max(1.0, float(np.abs(np.asarray(jgot)).max()))


# --------------------------------------------------------------------------- #
# prune_style_transfer                                                         #
# --------------------------------------------------------------------------- #


def _jax_flops(g, x_shape):
    """The JAX package's Table-1 FLOP count (``benchmarks/table1_apps.py:55``)."""
    fn = jlower(g, use_kernels=False)
    params = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), g.params)
    lowered = jax.jit(fn).lower(params, jax.ShapeDtypeStruct(x_shape, jnp.float32))
    return float(cost_analysis(lowered.compile()).get("flops", 0.0))


@pytest.fixture(scope="module")
def style():
    """Both packages' style-transfer graphs at the twin's settings (base 32,
    one 128 x 128 frame) over the same numpy params and frame."""
    normal = jax.random.normal
    jax.random.normal = lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype)
    try:
        jg = jcnn.build_style_transfer(jax.random.PRNGKey(0), base=32)
    finally:
        jax.random.normal = normal
    pnp = numpy_params(jg)
    jg = dataclasses.replace(jg, params=jax.tree.map(jnp.asarray, pnp))
    x = np.random.default_rng(3).standard_normal(tst.INPUT_SHAPE).astype(np.float32)
    jmasks, jstructs = jcnn.app_masks(jg, "style_transfer", 0.5)
    jgo = jopt(jg, jmasks, jstructs)
    jplan = jcompile_plan(jgo, backend="reference")
    ops = {}
    for n in jgo.nodes:
        ops[n.op] = ops.get(n.op, 0) + 1
    want = dict(
        flops={"unpruned": _jax_flops(jg, tst.INPUT_SHAPE),
               "pruned_compiler": _jax_flops(jgo, tst.INPUT_SHAPE)},
        param_bytes={"unpruned": int(sum(np.asarray(v).nbytes for v in jax.tree.leaves(jg.params))),
                     "pruned_compiler": int(sum(np.asarray(v).nbytes
                                                for v in jax.tree.leaves(jgo.params)))},
        plan_steps=len(jplan.steps),
        peak=jplan.memory_estimate(jax.ShapeDtypeStruct(tst.INPUT_SHAPE, jnp.float32))[
            "peak_activation_bytes"],
        ops=ops,
        out=np.asarray(jax.jit(jplan)(jgo.params, jnp.asarray(x))),
    )
    g = tcnn.build_style_transfer(base=32, params=pnp, device="cpu")
    got = tst.bench(g, torch.from_numpy(x), reps=1)
    return dict(got=got, want=want)


def test_style_transfer_plan_quantities_equal_jax(style):
    got, want = style["got"], style["want"]
    assert got["op_histogram"] == want["ops"]
    assert got["plan_steps"] == want["plan_steps"]
    assert got["param_bytes"] == want["param_bytes"]
    assert got["peak_activation_bytes"] == want["peak"]
    assert set(got["ms"]) == set(tst.VARIANTS) and all(v > 0 for v in got["ms"].values())


def test_style_transfer_outputs_agree_with_jax(style):
    got, want = style["got"], style["want"]
    tol = 1e-3 * max(1.0, float(np.abs(want["out"]).max()))
    assert float(np.abs(_np(got["out"]) - want["out"]).max()) <= tol
    assert got["agreement_max_err"] <= tol
    assert got["kernel_vs_reference_err"] <= tol


def test_style_transfer_flops_within_the_measured_gap_to_xla(style):
    got, want = style["got"]["flops"], style["want"]["flops"]
    for v in ("unpruned", "pruned_compiler"):
        assert got[v] == pytest.approx(want[v], rel=FLOP_RTOL), v
    cut = got["unpruned"] / got["pruned_compiler"]
    jcut = want["unpruned"] / want["pruned_compiler"]
    assert cut == pytest.approx(jcut, rel=FLOP_CUT_RTOL)


# --------------------------------------------------------------------------- #
# serve_pruned_lm                                                              #
# --------------------------------------------------------------------------- #


def _jax_prune(params):
    """The JAX script's one-shot prune (``examples/serve_pruned_lm.py:35-49``),
    also returning each pruned leaf's mask by path."""
    assigned = jdefault_plan(0.5).assign(params)
    flat, treedef = jtu.tree_flatten_with_path(params)
    out, masks = [], {}
    for path, w in flat:
        st = assigned.get(jtu.keystr(path))
        if st is not None:
            w, masks[jtu.keystr(path)] = jpr.project(w, st)
            w = w.astype(jnp.float32)
        out.append(w)
    return jtu.tree_unflatten(treedef, out), masks


@pytest.fixture(scope="module")
def served():
    cfg = tserve.small_lm()
    pnp = numpy_lm(cfg, seed=11)
    params, masks = tserve.prune(lm_params_from_numpy(pnp, device="cpu"))
    jparams, jmasks = _jax_prune(_tree_map(jnp.asarray, pnp))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    tokens = Engine(get_model(cfg, device="cpu"), params, batch_size=4, max_len=96).generate(
        torch.from_numpy(prompts), 24).tokens
    jmodel = jget_model(dataclasses.replace(tserve.small_lm(), name="qwen2.5-serve-demo"))
    jcfg = jmodel.cfg
    jtokens = JEngine(jmodel, jparams, batch_size=4, max_len=96).generate(
        jnp.asarray(prompts), 24).tokens
    return dict(cfg=cfg, jcfg=jcfg, params=params, masks=masks, jparams=jparams, jmasks=jmasks,
                prompts=prompts, tokens=tokens, jtokens=jtokens, jmodel=jmodel)


def test_serve_prune_stage_prunes_the_same_leaves_as_jax(served):
    masks, jmasks = served["masks"], served["jmasks"]
    assert sorted(masks) == sorted(jmasks) and len(masks) == 16
    for path in masks:
        _eq(masks[path], jmasks[path])
    jleaves = {jtu.keystr(p): v for p, v in jtu.tree_flatten_with_path(served["jparams"])[0]}
    for path, w in leaves_with_path(served["params"]):
        _eq(w, jleaves[path])


def test_serve_engine_tokens_equal_jax_up_to_the_first_near_tie(served):
    from repro.models import transformer as jlm

    tokens, jtokens, prompts = served["tokens"], served["jtokens"], served["prompts"]
    assert tokens.shape == jtokens.shape == (4, 24)
    for row in range(4):
        # JAX's teacher-forced logits over its own continuation: the margins
        forced = np.concatenate([prompts[row], jtokens[row, :-1]])[None]
        logits = np.asarray(jlm.forward(served["jparams"], served["jcfg"],
                                        jnp.asarray(forced))[0])[0, len(prompts[row]) - 1:]
        top2 = np.sort(logits[:, : served["cfg"].vocab], axis=-1)[:, -2:]
        ties = np.nonzero(top2[:, 1] - top2[:, 0] < TIE)[0]
        upto = int(ties[0]) if len(ties) else 24
        np.testing.assert_array_equal(tokens[row, :upto], jtokens[row, :upto])


# --------------------------------------------------------------------------- #
# train_lm_100m                                                                #
# --------------------------------------------------------------------------- #

TRAIN_STEPS = 5


def test_train_tiny_first_steps_match_jax():
    cfg = ttrain.lm_tiny()
    pnp = numpy_lm(cfg, seed=13)
    args = SimpleNamespace(steps=TRAIN_STEPS, batch=4, seq=32, tiny=True, prune=True, ckpt=None)
    rep = ttrain.train(args, cfg, lm_params_from_numpy(pnp, device="cpu"),
                       torch.device("cpu"), log=lambda _: None)

    # the JAX script's loop (``examples/train_lm_100m.py:65-99``) on the same params
    jmodel = jget_model(dataclasses.replace(cfg))
    opt_cfg = JAdamWConfig(lr=2e-3, total_steps=TRAIN_STEPS, warmup_steps=5)
    admm_cfg = jpr.AdmmConfig(rho=1e-2, rho_ramp=1.2, rho_max=1.0, update_every=20)
    state = jinit_state(_tree_map(jnp.asarray, pnp), opt_cfg, admm_cfg=admm_cfg,
                        prune_plan=jdefault_plan(0.5))
    step = jax.jit(jmake_step(jmodel.loss, opt_cfg, admm_cfg=admm_cfg))
    pipe = JPipeline(jmodel.cfg, batch=4, seq=33, seed=0)
    ces, hard_at, jrep = [], int(TRAIN_STEPS * 0.6), None
    for i in range(TRAIN_STEPS):
        state, m = step(state, {k: jnp.asarray(v) for k, v in pipe.next().items()})
        ces.append(float(m["ce"]))
        if i == hard_at:
            pruned, masks = jpr.hard_prune(state.params, state.admm)
            jrep = jpr.tree_sparsity_report(pruned, masks)
            state = JTrainState(params=pruned, opt=state.opt, admm=None, masks=masks)
            step = jax.jit(jmake_step(jmodel.loss, opt_cfg))

    got = [h["ce"] for h in rep["history"]]
    np.testing.assert_allclose(got, ces, rtol=0, atol=1e-4)
    assert rep["hard_at"] == hard_at
    assert rep["sparsity"]["pruned_global"] == pytest.approx(
        float(jrep["pruned_global"]), abs=1e-7)
    assert rep["sparsity"]["pruned_global"] == pytest.approx(0.5, abs=0.05)


# --------------------------------------------------------------------------- #
# the twins as entry points                                                    #
# --------------------------------------------------------------------------- #


def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m"] + args, capture_output=True, text=True,
                         timeout=timeout, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


RUNS = {
    "quickstart": ([], ("OK", "BSR kernel vs dense max err")),
    "prune_style_transfer": ([], ("compiler FLOP cut", "optimized graph op histogram")),
    "serve_pruned_lm": ([], ("OK", "continuous batching")),
    "train_lm_100m": (["--tiny", "--steps", "25", "--prune"], ("hard prune", "trained 25 steps")),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_twin_runs_on_the_cpu_and_prints_the_jax_scripts_markers(name, tmp_path):
    extra, markers = RUNS[name]
    if name == "train_lm_100m":
        extra = extra + ["--ckpt", str(tmp_path / "ckpt")]
    out = _run([f"repro_torch.examples.{name}", "--device", "cpu"] + extra)
    for marker in markers:
        assert marker in out, (marker, out)


@pytest.mark.parametrize("mod", [tqs, tst, tserve, ttrain], ids=lambda m: m.__name__)
def test_twin_raises_without_a_gpu(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--tiny", "--steps", "2"] if mod is ttrain else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
