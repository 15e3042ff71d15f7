"""The port's training half against the JAX package, on the CPU, at the
smoke config of qwen2.5-3b (2 layers, d_model 128, f32): ``loss_fn``,
AdamW, ``make_train_step`` (ADMM penalty, Z/U updates, accumulation,
masks), the launcher's ADMM -> hard prune -> masked pipeline, the data
pipeline, checkpoints, the fault-tolerance plumbing and
``launch.train.main``.

Both packages get the same numpy params (``numpy_lm`` of
``tests/test_torch_decode.py``) and the same batches.  What is held, and
why each tolerance:

* bit-equal: ``SyntheticPipeline`` batches (a numpy copy); checkpoint round
  trips; a resumed run against an uninterrupted one (the CPU is
  deterministic); an f32 checkpoint written by the JAX package, restored by
  the port;
* ``loss_fn`` within rtol 1e-5 and its gradients within 1e-4 of the
  largest gradient of each leaf (the same f32 ops, summed in another
  order);
* ``adamw_update`` on identical inputs: params, moments and the grad norm
  within rtol 1e-5 (f32; bf16 params within one bf16 ulp);
* one ``make_train_step`` from the same state (accum 1 and 4): loss, ce,
  grad norm and primal residual within rtol 1e-5; params within
  ``2 * lr`` of JAX's -- at step 1 Adam's update is ``g / (|g| + eps)``, so
  a gradient element at rounding level can flip sign between the packages
  and move a weight by twice the learning rate -- and 99.9% of them within
  1e-6;
* the launcher's free-running pipeline (6 ADMM steps with 3 Z/U updates,
  hard prune, 4 masked steps): the loss and primal residual of every step
  within rtol 1e-3 (the sign flips above feed later steps), the same steps
  updating Z/U, the same sparsity after the hard prune.
"""

import dataclasses
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jsmoke_config
from repro.core import pruning as jpr
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.launch.train import default_prune_plan as jdefault_plan
from repro.models import get_model as jget_model
from repro.models import transformer as jlm
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training.train_loop import init_train_state as jinit_state
from repro.training.train_loop import make_train_step as jmake_step
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import pruning as tpr
from repro_torch.data.pipeline import PipelineState, SyntheticPipeline
from repro_torch.launch import train as tlaunch
from repro_torch.launch.train import default_prune_plan
from repro_torch.models import get_model
from repro_torch.models import transformer as tlm
from repro_torch.models.sharding import P
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optimizer as topt
from repro_torch.training.fault_tolerance import (
    Heartbeat,
    PreemptionHandler,
    StragglerMonitor,
    retry,
)
from repro_torch.training.train_loop import TrainState, init_train_state, make_train_step
from repro_torch.utils.tree import leaves, leaves_with_path, map_with_path
from test_torch_decode import _tree_map, numpy_lm

BATCH, SEQ = 8, 32
ADMM = dict(rho=1e-2, rho_ramp=1.2, rho_max=1.0)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


@pytest.fixture(scope="module")
def lm():
    cfg, jcfg = smoke_config("qwen2.5-3b"), jsmoke_config("qwen2.5-3b")
    return dict(cfg=cfg, jcfg=jcfg, pnp=numpy_lm(cfg, seed=5), jmodel=jget_model(jcfg),
                model=get_model(cfg, device="cpu"))


def _params(lm):
    return lm_params_from_numpy(lm["pnp"], device="cpu")


def _batches(cfg, n, seed=0):
    pipe = SyntheticPipeline(cfg, batch=BATCH, seq=SEQ + 1, seed=seed)
    return [pipe.next() for _ in range(n)]


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _opt_cfg(steps=10, lr=1e-3):
    return dict(lr=lr, total_steps=steps, warmup_steps=max(steps // 20, 5))


# --------------------------------------------------------------------------- #
# data                                                                         #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", [0, 3])
def test_pipeline_batches_bit_identical_to_jax(lm, seed):
    a = SyntheticPipeline(lm["cfg"], batch=4, seq=17, seed=seed)
    b = JPipeline(lm["jcfg"], batch=4, seq=17, seed=seed)
    for step in range(3):
        x, y = a.next(), b.next()
        assert x.keys() == y.keys() == {"tokens", "labels"}
        for k in x:
            assert x[k].dtype == y[k].dtype == np.int32
            np.testing.assert_array_equal(x[k], y[k])
    np.testing.assert_array_equal(a.global_batch(9)["tokens"], b.global_batch(9)["tokens"])
    assert a.state.to_dict() == b.state.to_dict() == {"data_step": 3}
    assert PipelineState.from_dict({"data_step": "7"}).step == 7


def test_data_determinism_sharding_and_structure(lm):
    cfg = lm["cfg"]
    a = SyntheticPipeline(cfg, batch=8, seq=16, seed=3)
    g = a.global_batch(7)
    parts = [a.host_shard(g, h, 4)["tokens"] for h in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), g["tokens"])
    np.testing.assert_array_equal(g["tokens"][:, 1:], g["labels"][:, :-1])
    toks = SyntheticPipeline(cfg, batch=32, seq=64, seed=0).next()["tokens"]
    pairs = {}
    for row in toks:
        for x, y in zip(row[:-1], row[1:]):
            pairs.setdefault(int(x), []).append(int(y))
    assert np.mean([len(set(v)) for v in pairs.values() if len(v) >= 3]) < cfg.vocab / 8


# --------------------------------------------------------------------------- #
# loss                                                                         #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("weighted", [False, True])
def test_loss_fn_and_gradients_match_jax(lm, weighted):
    b = _batches(lm["cfg"], 1)[0]
    if weighted:
        b["weights"] = np.random.default_rng(1).uniform(0, 2, b["labels"].shape).astype(
            np.float32)
    jparams = _tree_map(jnp.asarray, lm["pnp"])
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, lm["jcfg"], _j(b)), has_aux=True)(jparams)
    params = _params(lm)
    ws = leaves(params)
    for w in ws:
        w.requires_grad_(True)
    loss, m = tlm.loss_fn(params, lm["cfg"], _t(b))
    grads = torch.autograd.grad(loss, ws)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(m["ce"].item(), float(jm["ce"]), rtol=1e-5)
    assert m["aux"].item() == float(jm["aux"]) == 0.0
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jg)[0], grads):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()) + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))


def test_loss_fn_takes_only_the_default_tpu_knobs(lm):
    """Every knob runs and gives the default loss bit for bit on plain
    tensors: the memory knobs (``remat``, ``layout_scan``;
    ``tests/test_torch_model_knobs.py`` holds them to JAX) and the sharding
    knob ``residual_spec``, a constraint that only redistributes DTensors
    (``tests/test_torch_distributed.py`` runs it on a mesh)."""
    b = _t(_batches(lm["cfg"], 1)[0])
    default = tlm.loss_fn(_params(lm), lm["cfg"], b)[0].item()
    for kw in (dict(remat=True), dict(remat=True, remat_policy="dots"), dict(layout_scan=True),
               dict(attn_chunk=512), dict(residual_spec=None),
               dict(residual_spec=P("data", "model", None))):
        assert tlm.loss_fn(_params(lm), lm["cfg"], b, **kw)[0].item() == default, kw
    full, _ = tlm.loss_fn(_params(lm), lm["cfg"], b, attn_impl="full")
    assert full.item() == tlm.loss_fn(_params(lm), lm["cfg"], b)[0].item()
    # the chunked (online-softmax) sdpa is ported: the same loss to rounding
    chunked, _ = tlm.loss_fn(_params(lm), lm["cfg"], b, attn_impl="chunked")
    np.testing.assert_allclose(chunked.item(), full.item(), rtol=1e-6)


# --------------------------------------------------------------------------- #
# optimizer                                                                    #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("step", [0, 2, 4, 5, 7, 50, 99, 150])
def test_schedules_match_jax(step):
    cfg = dict(lr=2e-3, warmup_steps=5, total_steps=100, min_lr_frac=0.1)
    want = float(jopt.cosine_schedule(jnp.asarray(step), jopt.AdamWConfig(**cfg)))
    got = topt.cosine_schedule(step, topt.AdamWConfig(**cfg))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got == float(np.float32(got))  # an exact f32 value
    np.testing.assert_allclose(topt.linear_warmup(step, 8),
                               float(jopt.linear_warmup(jnp.asarray(step), 8)), rtol=1e-7)


def test_cosine_schedule_shape():
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    lrs = [topt.cosine_schedule(s, cfg) for s in (0, 9, 10, 50, 99)]
    assert lrs[0] < lrs[1] <= 1.0 + 1e-6
    assert lrs[-1] == pytest.approx(0.1, abs=0.02)


def _opt_inputs(seed, param_dtype):
    rng = np.random.default_rng(seed)
    shapes = {"w": (48, 32), "b": (32,), "emb": (20, 16), "scale": (16,)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (rng.standard_normal(s) * 0.3).astype(np.float32) for k, s in shapes.items()}
    m = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in shapes.items()}
    v = {k: (rng.uniform(0, 0.05, s)).astype(np.float32) for k, s in shapes.items()}
    if param_dtype == "bfloat16":  # bf16 params and grads: the same values in both
        p = {k: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for k, a in p.items()}
        g = {k: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for k, a in g.items()}
    return p, g, m, v


@pytest.mark.parametrize("param_dtype,state_dtype,clip", [
    ("float32", "float32", 1.0), ("float32", "float32", 0.0), ("bfloat16", "float32", 1.0),
    ("float32", "bfloat16", 1.0)])
def test_adamw_update_matches_jax_on_identical_inputs(param_dtype, state_dtype, clip):
    p, g, m, v = _opt_inputs(7, param_dtype)
    cfg = dict(lr=3e-3, weight_decay=0.1, grad_clip=clip, warmup_steps=2, total_steps=20,
               state_dtype=state_dtype)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[param_dtype]
    sj, st = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[state_dtype]
    jstate = jopt.AdamWState(jnp.asarray(3, jnp.int32),
                             {k: jnp.asarray(a, sj) for k, a in m.items()},
                             {k: jnp.asarray(a, sj) for k, a in v.items()})
    jp, js, jmet = jopt.adamw_update({k: jnp.asarray(a, jdt) for k, a in g.items()}, jstate,
                                     {k: jnp.asarray(a, jdt) for k, a in p.items()},
                                     jopt.AdamWConfig(**cfg))
    # the port updates in place: it gets copies, and JAX (dispatched
    # asynchronously, its inputs possibly aliasing the numpy arrays) is done
    jax.block_until_ready((jp, js, jmet))
    tstate = topt.AdamWState(3, {k: torch.tensor(a).to(st) for k, a in m.items()},
                             {k: torch.tensor(a).to(st) for k, a in v.items()})
    params = {k: torch.tensor(a).to(tdt) for k, a in p.items()}
    tp, ts, tmet = topt.adamw_update({k: torch.tensor(a).to(tdt) for k, a in g.items()},
                                     tstate, params, topt.AdamWConfig(**cfg))
    assert ts.step == int(js.step) == 4
    assert tp["w"] is params["w"]  # updated in place
    np.testing.assert_allclose(tmet["grad_norm"].item(), float(jmet["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(tmet["lr"], float(jmet["lr"]), rtol=1e-6)
    for k in p:
        assert tp[k].dtype == tdt and ts.m[k].dtype == st
        want = np.asarray(jp[k].astype(jnp.float32))
        if param_dtype == "bfloat16":  # one bf16 ulp at each value's magnitude
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
            assert (np.abs(_np(tp[k]) - want) <= ulp).all(), k
        else:
            np.testing.assert_allclose(_np(tp[k]), want, rtol=1e-5, atol=1e-7)
        tol = dict(rtol=1e-5, atol=1e-9) if state_dtype == "float32" else dict(rtol=1e-2,
                                                                              atol=1e-6)
        np.testing.assert_allclose(_np(ts.m[k]), np.asarray(js.m[k].astype(jnp.float32)), **tol)
        np.testing.assert_allclose(_np(ts.v[k]), np.asarray(js.v[k].astype(jnp.float32)), **tol)
    # the 1-D leaves are not decayed: with a zero gradient and zero moments
    # they stay put, the matrices shrink
    z = {"w": torch.ones(4, 4), "b": torch.ones(4)}
    st0 = topt.adamw_init(z, topt.AdamWConfig())
    out, _, _ = topt.adamw_update({k: torch.zeros_like(t) for k, t in z.items()}, st0, z,
                                  topt.AdamWConfig(lr=0.1, warmup_steps=1))
    assert torch.equal(out["b"], torch.ones(4)) and (out["w"] < 1).all()


def test_clip_and_global_norm_match_jax():
    rng = np.random.default_rng(4)
    g = {"a": rng.standard_normal((8, 8)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    jg, jn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 0.5)
    tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    out, n = topt.clip_by_global_norm(tg, 0.5)
    np.testing.assert_allclose(n.item(), float(jn), rtol=1e-6)
    assert out["a"] is tg["a"]
    for k in g:
        np.testing.assert_allclose(_np(out[k]), np.asarray(jg[k]), rtol=1e-6)
    np.testing.assert_allclose(topt.global_norm(out).item(), 0.5, rtol=1e-5)


# --------------------------------------------------------------------------- #
# train step                                                                   #
# --------------------------------------------------------------------------- #


def _assert_params_close(params, jparams, lr):
    diffs = []
    for (path, want), (tpath, got) in zip(
            jax.tree_util.tree_flatten_with_path(jparams)[0], leaves_with_path(params)):
        assert jax.tree_util.keystr(path) == tpath
        d = np.abs(_np(got) - np.asarray(want, np.float32)).ravel()
        assert d.max() <= 2 * lr + 1e-6, (tpath, d.max())
        diffs.append(d)
    d = np.concatenate(diffs)
    assert (d <= 1e-6).mean() >= 0.999, (d > 1e-6).mean()


@pytest.mark.parametrize("accum", [1, 4])
def test_train_step_matches_jax(lm, accum):
    b = _batches(lm["cfg"], 1)[0]
    opt = _opt_cfg()
    acfg = dict(ADMM, update_every=1)
    jstate = jinit_state(_tree_map(jnp.asarray, lm["pnp"]), jopt.AdamWConfig(**opt),
                         admm_cfg=jpr.AdmmConfig(**acfg), prune_plan=jdefault_plan(0.5))
    jstep = jax.jit(jmake_step(lm["jmodel"].loss, jopt.AdamWConfig(**opt),
                               admm_cfg=jpr.AdmmConfig(**acfg), accum=accum))
    jstate, jm = jstep(jstate, _j(b))
    state = init_train_state(_params(lm), topt.AdamWConfig(**opt),
                             admm_cfg=tpr.AdmmConfig(**acfg), prune_plan=default_prune_plan(0.5))
    step = make_train_step(lm["model"].loss, topt.AdamWConfig(**opt),
                           admm_cfg=tpr.AdmmConfig(**acfg), accum=accum)
    state, m = step(state, _t(b))
    assert set(m) == set(jm) == {"loss", "ce", "aux", "grad_norm", "lr", "primal_residual",
                                 "rho"}
    for k in ("loss", "ce", "grad_norm", "primal_residual", "lr", "rho"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert state.opt.step == int(jstate.opt.step) == 1
    assert state.admm.n_updates == int(jstate.admm.n_updates) == 1
    lr0 = topt.cosine_schedule(0, topt.AdamWConfig(**opt))
    _assert_params_close(state.params, jstate.params, lr0)
    # the Z-step of this update: the same kept units
    for (path, want), (_, got) in zip(jax.tree_util.tree_flatten_with_path(jstate.admm.z)[0],
                                      leaves_with_path(state.admm.z)):
        np.testing.assert_array_equal(_np(got) != 0, np.asarray(want) != 0)


def test_accumulation_matches_the_full_batch(lm):
    b = _t(_batches(lm["cfg"], 1)[0])
    opt = topt.AdamWConfig(**_opt_cfg())
    s1, m1 = make_train_step(lm["model"].loss, opt)(init_train_state(_params(lm), opt), b)
    s4, m4 = make_train_step(lm["model"].loss, opt, accum=4)(init_train_state(_params(lm), opt),
                                                             b)
    np.testing.assert_allclose(m4["loss"].item(), m1["loss"].item(), rtol=1e-5)
    for a, c in zip(leaves(s1.params), leaves(s4.params)):
        assert (a - c).abs().max().item() < 5e-3


def test_masks_apply_to_params_in_the_loss_and_to_gradients(lm):
    opt = topt.AdamWConfig(**_opt_cfg())
    params = _params(lm)
    st = tpr.admm_init(params, default_prune_plan(0.5), tpr.AdmmConfig())
    _, masks = tpr.hard_prune(params, st)
    # raw weights off zero at pruned positions: the loss must not see them
    state = init_train_state(params, opt, masks=masks)
    b = _t(_batches(lm["cfg"], 1)[0])
    want = lm["model"].loss(tpr.apply_masks(params, masks), b)[0].item()
    grads_seen = {}

    def spy(p, batch):
        return lm["model"].loss(p, batch)

    state, m = make_train_step(spy, opt)(state, b)
    assert m["loss"].item() == pytest.approx(want, rel=1e-6)
    del grads_seen
    # a zero gradient at pruned positions: the first step leaves them as
    # decay alone moves them, p * (1 - lr * wd)
    w0 = _params(lm)["layers"][0]["attn"]["w_q"]["w"]
    mk = masks["layers"][0]["attn"]["w_q"]["w"]
    w1 = state.params["layers"][0]["attn"]["w_q"]["w"]
    lr = topt.cosine_schedule(0, opt)
    decayed = (w0 - lr * 0.1 * w0)[mk == 0]
    np.testing.assert_allclose(w1[mk == 0].numpy(), decayed.numpy(), rtol=1e-6, atol=1e-8)


# --------------------------------------------------------------------------- #
# the launcher's pipeline                                                      #
# --------------------------------------------------------------------------- #

STEPS, EVERY, HARD = 10, 2, 0.5


def _args(**kw):
    base = dict(arch="qwen2.5-3b", smoke=True, steps=STEPS, batch=BATCH, seq=SEQ, lr=1e-3,
                accum=1, prune=True, sparsity=0.5, admm_every=EVERY, hard_prune_at=HARD,
                ckpt=None, save_every=50, seed=0, device="cpu")
    base.update(kw)
    return tlaunch.build_parser().parse_args(
        [a for k, v in base.items() for a in (
            [f"--{k.replace('_', '-')}"] if v is True else
            [] if v is False or v is None else [f"--{k.replace('_', '-')}", str(v)])])


def _jax_launcher_run(lm, args):
    """The JAX launcher's loop (``repro.launch.train.main``) on the numpy
    params; returns per-step (loss, residual) and the hard prune's report."""
    jcfg = lm["jcfg"]
    pipe = JPipeline(jcfg, batch=args.batch, seq=args.seq + 1, seed=args.seed)
    opt = jopt.AdamWConfig(lr=args.lr, total_steps=args.steps,
                           warmup_steps=max(args.steps // 20, 5))
    acfg = jpr.AdmmConfig(update_every=args.admm_every, **ADMM)
    state = jinit_state(_tree_map(jnp.asarray, lm["pnp"]), opt, admm_cfg=acfg,
                        prune_plan=jdefault_plan(args.sparsity))
    step_fn = jax.jit(jmake_step(lm["jmodel"].loss, opt, admm_cfg=acfg))
    hard_at = int(args.steps * args.hard_prune_at)
    out, rep, n_updates = [], None, None
    for step in range(args.steps):
        state, m = step_fn(state, {k: jnp.asarray(v) for k, v in pipe.next().items()})
        out.append((float(m["loss"]), float(m.get("primal_residual", 0.0))))
        if step == hard_at:
            n_updates = int(state.admm.n_updates)
            pruned, masks = jpr.hard_prune(state.params, state.admm)
            from repro.training.train_loop import TrainState as JTrainState

            state = JTrainState(params=pruned, opt=state.opt, admm=None, masks=masks)
            step_fn = jax.jit(jmake_step(lm["jmodel"].loss, opt))
            rep = jpr.tree_sparsity_report(pruned, masks)
    return out, rep, n_updates, state


@pytest.fixture(scope="module")
def pipeline_runs(lm):
    args = _args()
    jout, jrep, jn, jstate = _jax_launcher_run(lm, args)
    logs = []
    report = tlaunch.train(args, lm["cfg"], _params(lm), torch.device("cpu"), log=logs.append)
    return dict(args=args, jout=jout, jrep=jrep, jn=jn, jstate=jstate, report=report, logs=logs)


def test_launcher_pipeline_losses_match_jax(pipeline_runs):
    r = pipeline_runs
    hist = r["report"]["history"]
    hard_at = int(STEPS * HARD)
    assert [h["phase"] for h in hist] == ["admm"] * (hard_at + 1) + ["masked"] * (
        STEPS - hard_at - 1)
    assert (hard_at + 1, STEPS - hard_at - 1) == (6, 4)
    # the JAX condition: post-increment step % every == 0, ADMM phase only
    assert [h["update"] for h in hist] == [
        (i + 1) % EVERY == 0 and i <= hard_at for i in range(STEPS)]
    assert r["report"]["n_updates"] == r["jn"] == 3
    for h, (jl, jres) in zip(hist, r["jout"]):
        np.testing.assert_allclose(h["loss"], jl, rtol=1e-3, err_msg=str(h["step"]))
        np.testing.assert_allclose(h.get("primal_residual", 0.0), jres, rtol=1e-3, atol=1e-7)
    # ||W - Z|| / ||W|| <= 1 while Z = Pi(W), before the second update (step
    # 3); after it Z = Pi(W + U) may exceed it, in both packages alike
    assert all(0 < res <= 1 for _, res in r["jout"][:3])
    # the penalty joins the loss: the ADMM losses exceed the ce
    assert all(h["loss"] > h["ce"] for h in hist if h["phase"] == "admm" and h["step"] > 0)
    assert all(h["loss"] == h["ce"] for h in hist if h["phase"] == "masked")
    rep, jrep = r["report"]["sparsity"], r["jrep"]
    assert rep["per_leaf"].keys() == jrep["per_leaf"].keys()
    assert rep["pruned_global"] == jrep["pruned_global"] == pytest.approx(0.5, abs=0.05)
    assert rho_ramp_ok(hist)


def rho_ramp_ok(hist):
    rho, want = [h["rho"] for h in hist if h["phase"] == "admm"], np.float32(1e-2)
    for h, got in zip(hist, rho):
        if h["update"]:
            want = min(want * np.float32(1.2), np.float32(1.0))
        if got != float(want):
            return False
    return True


def test_launcher_pipeline_masks_have_the_recipe_structure(pipeline_runs):
    r = pipeline_runs
    masks = r["report"]["masks"]
    params = r["report"]["state"].params
    n = 0
    for path, m in leaves_with_path(masks):
        n += 1
        if "attn" in path:  # Block(64, 64): constant on every tile
            k, c = m.shape
            tiles = m.reshape(k // 64, 64, c // 64, 64)
            assert (tiles == tiles[:, :1, :, :1]).all(), path
        else:  # Column: one value along each row
            assert (m == m[:, :1]).all(), path
    assert n == 8
    # after the fine-tune: the masked params are zero exactly where the masks are
    masked = tpr.apply_masks(params, masks)
    checked = []

    def zeros_exactly_where_masked(path, w, m):
        if m is not None:
            assert bool((w[m == 0] == 0).all()) and bool((w[m != 0] != 0).all()), path
            checked.append(path)

    map_with_path(zeros_exactly_where_masked, masked, masks)
    assert len(checked) == 8
    rep2 = tpr.tree_sparsity_report(params, masks)
    assert rep2["pruned_global"] == r["report"]["sparsity"]["pruned_global"]


def test_launcher_prints_the_jax_lines(pipeline_runs):
    logs = pipeline_runs["logs"]
    assert logs[0].startswith("step     0 loss=") and "residual=" in logs[0]
    assert any(s.startswith("  [hard prune] global sparsity over pruned leaves: 0.500") for s in
               logs)
    assert logs[-1].startswith("done; median step")
    assert all(h["ms"] > 0 for h in pipeline_runs["report"]["history"])
    assert pipeline_runs["report"]["peak_bytes"]["admm"] is None  # not measured on the CPU


def test_main_end_to_end_on_the_cpu(capsys):
    rep = tlaunch.main(["--smoke", "--device", "cpu", "--prune", "--steps", "6", "--batch", "4",
                        "--seq", "16", "--admm-every", "2"])
    out = capsys.readouterr().out
    assert "[hard prune]" in out and "done; median step" in out
    assert rep["n_updates"] == 2 and rep["masks"] is not None
    assert np.isfinite([h["loss"] for h in rep["history"]]).all()


def test_main_resumes_from_its_checkpoint(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "16", "--ckpt",
            str(tmp_path), "--save-every", "3"]
    first = tlaunch.main(argv + ["--steps", "6"])
    assert tckpt.all_steps(str(tmp_path)) == [3, 6]
    second = tlaunch.main(argv + ["--steps", "8"])
    assert "resumed from step 6" in capsys.readouterr().out
    assert [h["step"] for h in second["history"]] == [6, 7]
    assert second["state"].opt.step == 8
    assert first["state"].opt.step == 6


# --------------------------------------------------------------------------- #
# port-only behaviour (mirrors tests/test_training_system.py)                   #
# --------------------------------------------------------------------------- #


def test_train_loss_decreases(lm):
    opt = topt.AdamWConfig(lr=2e-3, total_steps=30, warmup_steps=2)
    state = init_train_state(_params(lm), opt)
    step = make_train_step(lm["model"].loss, opt)
    losses = []
    for b in _batches(lm["cfg"], 30):
        state, m = step(state, _t(b))
        losses.append(m["ce"].item())
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses[:3] + losses[-3:]


def test_admm_pipeline_prunes_and_keeps_sparsity(lm):
    opt = topt.AdamWConfig(lr=2e-3, total_steps=40, warmup_steps=2)
    acfg = tpr.AdmmConfig(rho=1e-2, update_every=5)
    state = init_train_state(_params(lm), opt, admm_cfg=acfg, prune_plan=default_prune_plan(0.5))
    step = make_train_step(lm["model"].loss, opt, admm_cfg=acfg)
    batches = _batches(lm["cfg"], 25)
    for b in batches[:20]:
        state, m = step(state, _t(b))
    assert state.admm.n_updates == 4 and m["primal_residual"].item() > 0
    pruned, masks = tpr.hard_prune(state.params, state.admm)
    rep = tpr.tree_sparsity_report(pruned, masks)
    assert rep["pruned_global"] == pytest.approx(0.5, abs=0.05)
    state2 = TrainState(params=pruned, opt=state.opt, admm=None, masks=masks)
    step2 = make_train_step(lm["model"].loss, opt)
    for b in batches[20:]:
        state2, _ = step2(state2, _t(b))
    rep2 = tpr.tree_sparsity_report(state2.params, masks)
    assert rep2["pruned_global"] == pytest.approx(rep["pruned_global"], abs=1e-6)


# --------------------------------------------------------------------------- #
# checkpoints                                                                  #
# --------------------------------------------------------------------------- #


def _copy_state(state):
    return map_with_path(lambda _, x: x.clone() if isinstance(x, torch.Tensor) else x, state)


def test_checkpoint_roundtrip_and_resume(lm, tmp_path):
    opt = topt.AdamWConfig(**_opt_cfg(20))
    acfg = tpr.AdmmConfig(update_every=3, **ADMM)
    pipe = SyntheticPipeline(lm["cfg"], batch=BATCH, seq=SEQ + 1, seed=0)
    state = init_train_state(_params(lm), opt, admm_cfg=acfg, prune_plan=default_prune_plan(0.5))
    step = make_train_step(lm["model"].loss, opt, admm_cfg=acfg)
    mgr = tckpt.CheckpointManager(str(tmp_path), save_every=3, keep=2)
    for i in range(6):
        state, _ = step(state, _t(pipe.next()))
        mgr.maybe_save(i + 1, (state, pipe.state.to_dict()))
    assert tckpt.all_steps(str(tmp_path)) == [3, 6]
    template = (init_train_state(_params(lm), opt, admm_cfg=acfg,
                                 prune_plan=default_prune_plan(0.5)), {"data_step": 0})
    (restored, data_state), at = mgr.restore_latest(template)
    assert at == 6 and data_state == {"data_step": 6}
    assert restored.opt.step == 6 and restored.admm.n_updates == 2
    assert restored.admm.rho == state.admm.rho and restored.admm.structures == state.admm.structures
    for (p, a), (q, b) in zip(leaves_with_path(restored), leaves_with_path(state)):
        assert p == q and (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b), p
    # resumed run == uninterrupted run, exactly on the CPU
    pipe_b = SyntheticPipeline(lm["cfg"], batch=BATCH, seq=SEQ + 1, seed=0)
    pipe_b.state = PipelineState.from_dict(data_state)
    for _ in range(3):
        restored, mb = step(restored, _t(pipe_b.next()))
        state, ma = step(state, _t(pipe.next()))
        assert mb["loss"].item() == ma["loss"].item()
    for a, b in zip(leaves(restored), leaves(state)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_checkpoint_carries_bf16_by_its_bits(tmp_path):
    w = torch.randn(5, 7, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    tree = {"w": w, "n": 3, "rho": 0.0120000001043, "i8": torch.arange(4, dtype=torch.int8)}
    path = tckpt.save(str(tmp_path), 2, tree, extra_meta={"note": "x"})
    with np.load(os.path.join(path, "arrays.npz")) as data:
        assert data["w"].dtype == np.uint16
    import json

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["dtypes"]["w"] == "bfloat16" and meta["note"] == "x" and meta["step"] == 2
    template = {"w": torch.zeros(5, 7, dtype=torch.bfloat16), "n": 0, "rho": 0.0,
                "i8": torch.zeros(4, dtype=torch.int8)}
    out, at = tckpt.restore(str(tmp_path), template)
    assert at == 2 and torch.equal(out["w"], w) and out["w"].dtype == torch.bfloat16
    assert out["n"] == 3 and out["rho"] == tree["rho"] and torch.equal(out["i8"], tree["i8"])


def test_checkpoint_atomicity_and_shape_check(tmp_path):
    tree = {"w": torch.ones(4, 4)}
    tckpt.save(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / "step_000000002.tmp")  # a dead write
    assert tckpt.latest_step(str(tmp_path)) == 1
    _, at = tckpt.restore(str(tmp_path), tree)
    assert at == 1
    with pytest.raises(ValueError):
        tckpt.restore(str(tmp_path), {"w": torch.ones(8, 4)})
    with pytest.raises(ValueError, match="mismatch"):
        tckpt.restore(str(tmp_path), {"v": torch.ones(4, 4)})
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "none"), tree)
    assert tckpt.CheckpointManager(str(tmp_path / "none")).restore_latest(tree) is None


def test_jax_f32_checkpoint_restores_in_the_port(lm, tmp_path):
    """A JAX train state after two ADMM steps, saved by the JAX package,
    restored into the port's template: the same keys and every value."""
    opt = dict(_opt_cfg())
    acfg = dict(update_every=2, **ADMM)
    b = _batches(lm["cfg"], 2)
    jstate = jinit_state(_tree_map(jnp.asarray, lm["pnp"]), jopt.AdamWConfig(**opt),
                         admm_cfg=jpr.AdmmConfig(**acfg), prune_plan=jdefault_plan(0.5))
    jstep = jax.jit(jmake_step(lm["jmodel"].loss, jopt.AdamWConfig(**opt),
                               admm_cfg=jpr.AdmmConfig(**acfg)))
    for x in b:
        jstate, _ = jstep(jstate, _j(x))
    jckpt.save(str(tmp_path), 2, (jstate, {"data_step": 2}))
    template = (init_train_state(_params(lm), topt.AdamWConfig(**opt),
                                 admm_cfg=tpr.AdmmConfig(**acfg),
                                 prune_plan=default_prune_plan(0.5)), {"data_step": 0})
    (state, data), at = tckpt.restore(str(tmp_path), template)
    assert at == 2 and data == {"data_step": 2}
    assert state.opt.step == 2 and state.admm.n_updates == 1
    assert state.admm.rho == float(jstate.admm.rho)
    jflat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    tflat = list(leaves_with_path(state))
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in tflat]
    for (_, want), (path, got) in zip(jflat, tflat):
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32), err_msg=path)
        else:
            assert got == want.item(), path
    # and the port writes the same keys the JAX package wrote
    tckpt.save(str(tmp_path / "port"), 2, (state, {"data_step": 2}))
    with np.load(tmp_path / "step_000000002" / "arrays.npz") as a, \
            np.load(tmp_path / "port" / "step_000000002" / "arrays.npz") as c:
        assert sorted(a.files) == sorted(c.files)


# --------------------------------------------------------------------------- #
# fault tolerance                                                              #
# --------------------------------------------------------------------------- #


def test_preemption_handler_flags_signal():
    with PreemptionHandler() as h:
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.should_stop and h.received == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) != h._handler


def test_retry_recovers_transients():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return 42

    assert retry(flaky, retries=5, backoff=0.001) == 42 and calls["n"] == 3
    with pytest.raises(OSError):
        retry(lambda: (_ for _ in ()).throw(OSError("x")), retries=1, backoff=0.001)


def test_straggler_monitor_detects():
    seen = []
    mon = StragglerMonitor(threshold=2.0, window=10, on_straggler=lambda *a: seen.append(a))
    for _ in range(6):
        mon.start_step()
        time.sleep(0.02)
        mon.end_step()
    mon.start_step()
    time.sleep(0.25)
    mon.end_step()
    assert mon.straggler_steps == [7] and len(seen) == 1 and mon.median > 0


def test_heartbeat_touches_its_file(tmp_path):
    path = tmp_path / "hb" / "beat"
    with Heartbeat(str(path), interval=0.05):
        time.sleep(0.15)
    assert path.exists() and float(path.read_text()) > 0
