"""The paper's ADMM recipe and gradient accumulation on a mesh, the port
against the JAX package, on the CPU, across processes.

The port runs as 4 gloo ranks (``tests/_torch_mesh_ranks.py``, case
``admm4``) on a (2, 2) ``(data, model)`` mesh behind a file rendezvous; the
JAX reference runs in one subprocess with
``--xla_force_host_platform_device_count=8`` on a (2, 2) mesh of
``AxisType.Auto`` axes (see ``tests/test_torch_distributed.py``).  Both
read the same numpy checkpoint of ``numpy_lm``'s smoke qwen2.5-3b.

The run on both sides: ``DEFAULT_RULES`` params, ZeRO-1 moments,
``launch/train.default_prune_plan(0.5)`` and ``AdmmConfig(update_every=2)``;
3 ADMM steps at ``accum`` 1 and at ``accum`` 2, then ``hard_prune`` and one
masked step.  The port also runs it unsharded.

Tolerances: ce, loss and the primal residual within 1e-5 (relative) of
JAX's sharded run and of the port's unsharded run (the same f32 ops, summed
in other orders); the hard-prune masks equal.  Z and U after the three
steps follow the weights, which carry Adam's amplification of rounding
(``tests/test_torch_training.py``: an update is ``m / (sqrt(v) + eps)``, so
a gradient element at rounding level moves its weight by up to a learning
rate): 99.9% of their elements within 1e-5 x max(1, max|JAX|) and all
within ``2 * lr`` (the port's unsharded run sits as far from JAX's, up to
~3.5e-5 on a handful of elements).  What the mesh itself adds is held
exactly: the Z/U update on sharded leaves is bit-equal to the update on the
gathered leaves, and each structure's projection of a sharded leaf is
bit-equal to ``project`` on the whole leaf.
"""

import numpy as np
import pytest

from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.training import checkpoint
from test_torch_decode import numpy_lm
from test_torch_distributed import _finish, _start_jax, _start_ranks

import _torch_mesh_ranks as ranks

RTOL = 1e-5
ACCUMS = (1, 2)
LR = 2e-3  # the run's AdamWConfig on both sides


def _inputs(rng):
    """Leaves with ties: values on a coarse grid, and repeated rows and
    columns (equal row / column / block norms)."""

    def tied(shape):
        w = np.round(rng.standard_normal(shape) * 2) / 2
        w[5], w[9] = w[0], w[0]
        w[:, 3], w[:, 40] = w[:, 0], w[:, 0]
        return w.astype(np.float32)

    return {"proj_w_o": tied((64, 128)), "proj_w_gate": tied((64, 128)),
            "proj_table": tied((128, 64))}


JAX_REF = """
import sys
import numpy as np
import jax
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import smoke_config
from repro.core.pruning.admm import AdmmConfig, hard_prune
from repro.data.pipeline import SyntheticPipeline
from repro.launch.train import default_prune_plan
from repro.models import get_model
from repro.models.sharding import param_pspecs
from repro.training import checkpoint
from repro.training.optimizer import AdamWConfig, zero1_pspecs
from repro.training.train_loop import TrainState, init_train_state, make_train_step

io = sys.argv[1]
out = {}
m22 = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                    devices=jax.devices()[:4])
cfg = smoke_config("qwen2.5-3b")
model = get_model(cfg)
tmpl = jax.eval_shape(model.init, jax.random.PRNGKey(0))
ocfg = AdamWConfig(lr=2e-3, total_steps=20, warmup_steps=2)
acfg = AdmmConfig(update_every=%(every)d)
plan = default_prune_plan(0.5)
is_p = lambda x: isinstance(x, P)

def place(tree, specs):
    return jax.tree.map(lambda s, a: jax.device_put(a, NamedSharding(m22, s)), specs, tree,
                        is_leaf=is_p)

for accum in (1, 2):
    params, _ = checkpoint.restore(io + "/params", tmpl)
    specs = param_pspecs(params)
    params = place(params, specs)
    state = init_train_state(params, ocfg, admm_cfg=acfg, prune_plan=plan)
    mv = zero1_pspecs(specs, params, data_size=2)
    state = TrainState(state.params, state.opt._replace(m=place(state.opt.m, mv),
                                                        v=place(state.opt.v, mv)), state.admm)
    step = jax.jit(make_train_step(model.loss, ocfg, admm_cfg=acfg, accum=accum))
    mstep = jax.jit(make_train_step(model.loss, ocfg, accum=accum))
    pipe = SyntheticPipeline(cfg, batch=8, seq=33, seed=0)
    batch = lambda: {k: jax.device_put(v, NamedSharding(m22, P("data", None)))
                     for k, v in pipe.next().items()}
    rows = []
    with m22:
        for _ in range(%(steps)d):
            state, met = step(state, batch())
            rows.append([float(met[k]) for k in ("ce", "loss", "primal_residual")])
        tag = "a%%d" %% accum
        out[tag + "_metrics"] = np.asarray(rows)
        out[tag + "_n_updates"] = np.asarray(int(state.admm.n_updates))
        zs = jax.tree_util.tree_flatten_with_path(state.admm.z)[0]
        out[tag + "_paths"] = np.asarray([jax.tree_util.keystr(p) for p, _ in zs])
        for i, ((_, z), u) in enumerate(zip(zs, jax.tree.leaves(state.admm.u))):
            out[tag + "_z%%d" %% i], out[tag + "_u%%d" %% i] = np.asarray(z), np.asarray(u)
        pruned, masks = jax.jit(hard_prune)(state.params, state.admm)
        for i, m in enumerate(jax.tree.leaves(masks)):
            out[tag + "_mask%%d" %% i] = np.asarray(m)
        state, met = mstep(TrainState(pruned, state.opt, None, masks), batch())
        out[tag + "_masked"] = np.asarray([float(met["ce"]), float(met["loss"])])
np.savez(io + "/jax.npz", **out)
""" % dict(every=ranks.ADMM_UPDATE_EVERY, steps=ranks.TRAIN_STEPS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    io_dir = tmp_path_factory.mktemp("admm")
    np.savez(io_dir / "inputs.npz", **_inputs(np.random.default_rng(0)))
    cfg = smoke_config("qwen2.5-3b")
    checkpoint.save(str(io_dir / "params"), 0, lm_params_from_numpy(numpy_lm(cfg), device="cpu"))
    _finish({"jax": _start_jax(io_dir, JAX_REF), "admm4": _start_ranks("admm4", 4, io_dir)})
    return {"jax": dict(np.load(io_dir / "jax.npz")),
            "port": dict(np.load(io_dir / "admm4_rank0.npz"))}


def _close(got, ref):
    """``(worst |got - ref|, share within 1e-5 x max(1, max|ref|))``."""
    d = np.abs(got - ref)
    return float(d.max()), float((d <= RTOL * max(1.0, np.abs(ref).max())).mean())


# --------------------------------------------------------------------------- #
# the ADMM steps                                                               #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("accum", ACCUMS)
def test_admm_steps_match_jax_sharded(runs, accum):
    """ce, loss and the primal residual of each ADMM step, and the masked
    step's ce and loss, within 1e-5 of the JAX package's sharded step."""
    p, j = runs["port"], runs["jax"]
    np.testing.assert_allclose(p[f"a{accum}_sharded_metrics"], j[f"a{accum}_metrics"], rtol=RTOL)
    np.testing.assert_allclose(p[f"a{accum}_sharded_masked"], j[f"a{accum}_masked"], rtol=RTOL)
    assert int(p[f"a{accum}_sharded_n_updates"]) == int(j[f"a{accum}_n_updates"]) == 1


@pytest.mark.parametrize("accum", ACCUMS)
def test_admm_steps_match_unsharded(runs, accum):
    p = runs["port"]
    np.testing.assert_allclose(p[f"a{accum}_sharded_metrics"], p[f"a{accum}_plain_metrics"],
                               rtol=RTOL)
    np.testing.assert_allclose(p[f"a{accum}_sharded_masked"], p[f"a{accum}_plain_masked"],
                               rtol=RTOL)
    ce = p[f"a{accum}_sharded_metrics"][:, 0]
    assert np.all(np.isfinite(ce)) and ce[-1] < ce[0]


@pytest.mark.parametrize("accum", ACCUMS)
def test_primal_residual_matches_jax(runs, accum):
    """The residual ``||W - Z|| / ||W||`` after each step: it falls once
    the Z/U update has run (step 2 of 3 with ``update_every=2``)."""
    p, j = runs["port"], runs["jax"]
    got, ref = p[f"a{accum}_sharded_metrics"][:, 2], j[f"a{accum}_metrics"][:, 2]
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    assert got[-1] < got[0]


@pytest.mark.parametrize("accum", ACCUMS)
def test_z_and_u_match_jax(runs, accum):
    p, j = runs["port"], runs["jax"]
    paths = list(j[f"a{accum}_paths"])
    assert list(p[f"a{accum}_sharded_paths"]) == paths and len(paths) > 0
    for ref_of in (lambda part, i: j[f"a{accum}_{part}{i}"],
                   lambda part, i: p[f"a{accum}_plain_{part}{i}"]):
        worst, within = [], []
        for i in range(len(paths)):
            for part in ("z", "u"):
                w, share = _close(p[f"a{accum}_sharded_{part}{i}"], ref_of(part, i))
                worst.append(w)
                within.append(share)
        assert max(worst) <= 2 * LR and min(within) >= 0.999, (max(worst), min(within))
    assert np.abs(p[f"a{accum}_sharded_u0"]).max() > 0  # the update ran


@pytest.mark.parametrize("accum", ACCUMS)
def test_z_u_update_on_the_mesh_is_exact(runs, accum):
    """``admm_update`` on the mesh's params, Z and U is bit-equal to
    ``admm_update`` on the same leaves gathered whole."""
    exact = runs["port"][f"a{accum}_sharded_update_exact"]
    assert exact.all() and len(exact) == 2 * len(runs["jax"][f"a{accum}_paths"])


@pytest.mark.parametrize("accum", ACCUMS)
def test_hard_prune_masks_equal_jax(runs, accum):
    p, j = runs["port"], runs["jax"]
    n = len(j[f"a{accum}_paths"])
    for i in range(n):
        np.testing.assert_array_equal(p[f"a{accum}_sharded_mask{i}"], j[f"a{accum}_mask{i}"])
        np.testing.assert_array_equal(p[f"a{accum}_sharded_mask{i}"],
                                      p[f"a{accum}_plain_mask{i}"])
        assert 0 < p[f"a{accum}_sharded_mask{i}"].mean() < 1


@pytest.mark.parametrize("accum", ACCUMS)
def test_z_u_and_masks_placed_like_the_weights(runs, accum):
    """Z, U, the hard-prune masks and the pruned weights are DTensors of
    each weight's placements and local shape: U on ``w_o`` is split over
    ``model`` on its rows, like ``w_o`` (``DEFAULT_RULES``), not over
    ``data`` like its ZeRO-1 moments.  (The JAX package pins no output
    sharding: under ZeRO-1 GSPMD hands U back as ``('model', 'data')``.)"""
    p, j = runs["port"], runs["jax"]
    placed = p[f"a{accum}_sharded_placed"]
    assert placed.all() and len(placed) == len(j[f"a{accum}_paths"])
    u_spec, w_spec = p[f"a{accum}_sharded_u_o"]
    assert u_spec == w_spec == "('model', None)"
    local, whole = p[f"a{accum}_sharded_u_o_local"]
    assert tuple(local) == (whole[0] // 2, whole[1])


# --------------------------------------------------------------------------- #
# the Z-step's projection on sharded leaves                                    #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("structure", ranks.PROJ_STRUCTURES)
def test_projection_of_sharded_leaves_is_the_whole_leafs(runs, structure):
    """Under ``DEFAULT_RULES`` and ``FSDP_RULES`` on a (2, 2) mesh, the
    projection of each leaf (rows, columns or both split) is bit-equal to
    ``project`` on the whole leaf, ties included, and keeps its placements."""
    p = runs["port"]
    ok = p[f"proj_{structure}"]
    assert ok.all() and len(ok) == 2 * 3, ok
    specs = set(p["proj_specs"])
    assert any("('model', 'data')" in s for s in specs)  # FSDP splits both dims
    assert any("(None, 'model')" in s for s in specs)
