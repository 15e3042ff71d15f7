"""The port's mesh modules against the JAX package's, on the CPU, across
processes: the sharded train step (``models/sharding``, ZeRO-1 moments,
DTensor params), the compressed all-reduce, the ring matmuls, GPipe and the
elastic checkpoint restore.

The port runs as gloo ranks (``tests/_torch_mesh_ranks.py``: 4 ranks for
``mesh4``, 8 for ``compress8``), one subprocess a rank meeting through a
file rendezvous in the test's tmp dir (no TCP port, so parallel test
workers cannot collide), each group under a wall limit.  The JAX reference
runs in one subprocess with ``--xla_force_host_platform_device_count=8`` on
meshes built with ``axis_types=(AxisType.Auto,) * n``: on jax 0.9
``jax.make_mesh`` defaults to ``Explicit`` axes, under which the JAX
package's own ``tests/test_distributed.py`` cases fail (ROADMAP C).  Both
sides read the same numpy inputs and the same params (a checkpoint of
``numpy_lm``'s tree, written by the port, restored by both packages).

Tolerances: train-step cross entropies within 1e-5 (relative) of JAX's
sharded run and of the port's unsharded step (the same f32 ops, summed in
other orders); the compressed means and errors within 1e-6; the ring
matmuls and their gradients within 1e-5; GPipe's forward equal to the
port's sequential loop and within 1e-6 of JAX's, its gradient within 1e-6;
the elastic restore bit-exact.
"""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.training import checkpoint
from test_torch_decode import numpy_lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mesh_ranks.py")
WALL_S = 120  # each group of processes, at most


def _inputs(rng):
    return {
        "ring_x": rng.standard_normal((16, 32)).astype(np.float32),
        "ring_w": (rng.standard_normal((32, 24)) * 0.1).astype(np.float32),
        "pipe_w": (rng.standard_normal((8, 16, 16)) * 0.2).astype(np.float32),
        "pipe_x": rng.standard_normal((4, 4, 16)).astype(np.float32),
        "pipe_y": rng.standard_normal((4, 4, 16)).astype(np.float32),
        "comp_g": rng.standard_normal((8, 16, 32)).astype(np.float32),
        "ce_logits": (rng.standard_normal((4, 6, 40)) * 3).astype(np.float32),
        "ce_labels": rng.integers(0, 40, (4, 6)),
    }


JAX_REF = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import smoke_config
from repro.data.pipeline import SyntheticPipeline
from repro.models import get_model
from repro.models.sharding import param_pspecs
from repro.training import checkpoint
from repro.training.collective_matmul import make_overlapped_tp_matmuls
from repro.training.compression import CompressionConfig, make_compressed_allreduce
from repro.training.optimizer import AdamWConfig
from repro.training.pipeline_parallel import make_pipelined_loss, pipeline_forward
from repro.training.train_loop import init_train_state, make_train_step

io = sys.argv[1]
inp = dict(np.load(io + "/inputs.npz"))
out = {}

def mesh(shape, names):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:n])

# the (2 data, 2 model) sharded train step
m22 = mesh((2, 2), ("data", "model"))
cfg = smoke_config("qwen2.5-3b")
model = get_model(cfg)
params, _ = checkpoint.restore(io + "/params", jax.eval_shape(model.init, jax.random.PRNGKey(0)))
p_sh = jax.tree.map(lambda s: NamedSharding(m22, s), param_pspecs(params))
params = jax.tree.map(jax.device_put, params, p_sh)
opt_cfg = AdamWConfig(lr=2e-3, total_steps=20, warmup_steps=2)
state = init_train_state(params, opt_cfg)
step = jax.jit(make_train_step(model.loss, opt_cfg))
pipe = SyntheticPipeline(cfg, batch=8, seq=33, seed=0)
ces = []
with m22:
    for _ in range(3):
        b = {k: jax.device_put(v, NamedSharding(m22, P("data", None)))
             for k, v in pipe.next().items()}
        state, met = step(state, b)
        ces.append(float(met["ce"]))
out["ce"] = np.asarray(ces)

# ring matmuls
ag, rs = make_overlapped_tp_matmuls(mesh((4,), ("model",)))
x, w = jnp.asarray(inp["ring_x"]), jnp.asarray(inp["ring_w"])
for name, fn in (("ag", ag), ("rs", rs)):
    out[name + "_y"] = np.asarray(jax.jit(fn)(x, w))
    dx, dw = jax.jit(jax.grad(lambda x, w: jnp.sum(fn(x, w) ** 2), argnums=(0, 1)))(x, w)
    out[name + "_dx"], out[name + "_dw"] = np.asarray(dx), np.asarray(dw)

# GPipe
mp = mesh((4,), ("pipe",))
pw = {"w": jnp.asarray(inp["pipe_w"])}
layer = lambda lp, h: jnp.tanh(h @ lp["w"])
px, py = jnp.asarray(inp["pipe_x"]), jnp.asarray(inp["pipe_y"])
out["pipe_out"] = np.asarray(pipeline_forward(layer, pw, px, mesh=mp))
loss = make_pipelined_loss(layer, lambda o, t: jnp.mean((o - t) ** 2), mesh=mp)
out["pipe_grad"] = np.asarray(jax.grad(loss)(pw, px, py)["w"])

# compressed all-reduce
m8 = mesh((8,), ("data",))
tmpl = {"w": jnp.zeros((16, 32))}
g = {"w": jnp.asarray(inp["comp_g"])}
zero = {"w": jnp.zeros((8, 16, 32))}
f = make_compressed_allreduce(m8, tmpl, cfg=CompressionConfig("int8"))
mean, err = f(g, zero)
mean2, _ = f(g, err)
out["int8_mean"], out["int8_err"], out["int8_mean2"] = (
    np.asarray(mean["w"]), np.asarray(err["w"]), np.asarray(mean2["w"]))
for policy, kw in (("topk", dict(topk_frac=0.5)), ("none", {})):
    f = make_compressed_allreduce(m8, tmpl, cfg=CompressionConfig(policy, **kw))
    mean, err = f(g, zero)
    out[policy + "_mean"], out[policy + "_err"] = np.asarray(mean["w"]), np.asarray(err["w"])
np.savez(io + "/jax.npz", **out)
"""


def _start_jax(io_dir, script_text=JAX_REF):
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    log = open(os.path.join(io_dir, "jax.log"), "w")
    script = os.path.join(io_dir, "jax_ref.py")
    with open(script, "w") as f:
        f.write(textwrap.dedent(script_text))
    return [subprocess.Popen([sys.executable, script, str(io_dir)], env=env, stdout=log,
                             stderr=subprocess.STDOUT)], [log]


def _start_ranks(case, world, io_dir):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(io_dir, f"{case}_rank{r}.log"), "w")
        procs.append(subprocess.Popen([sys.executable, WORKER, case, str(r), str(world),
                                       str(io_dir)], env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
        logs.append(log)
    return procs, logs


def _finish(groups, wall_s=WALL_S):
    """Wait for every group under the wall limit; kill them all on a
    timeout or a failure, and raise with the failing logs."""
    deadline = time.monotonic() + wall_s
    failed = []
    try:
        for name, (procs, logs) in groups.items():
            for i, p in enumerate(procs):
                try:
                    rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    rc = "timeout"
                if rc != 0:
                    failed.append((name, i, rc, logs[i].name))
    finally:
        for procs, logs in groups.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
    if failed:
        msgs = []
        for name, i, rc, path in failed[:3]:
            with open(path) as f:
                msgs.append(f"{name}[{i}] rc={rc}:\n{f.read()[-3000:]}")
        raise AssertionError("\n\n".join(msgs))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    io_dir = tmp_path_factory.mktemp("mesh")
    np.savez(io_dir / "inputs.npz", **_inputs(np.random.default_rng(0)))
    cfg = smoke_config("qwen2.5-3b")
    checkpoint.save(str(io_dir / "params"), 0, lm_params_from_numpy(numpy_lm(cfg), device="cpu"))
    groups = {"jax": _start_jax(io_dir), "mesh4": _start_ranks("mesh4", 4, io_dir),
              "compress8": _start_ranks("compress8", 8, io_dir)}
    _finish(groups)
    load = lambda name: dict(np.load(io_dir / name))  # noqa: E731
    return {"jax": load("jax.npz"), "mesh4": load("mesh4_rank0.npz"),
            "compress8": [load(f"compress8_rank{r}.npz") for r in range(8)]}


# --------------------------------------------------------------------------- #
# the sharded train step                                                       #
# --------------------------------------------------------------------------- #


def test_sharded_train_step_matches_jax_sharded(runs):
    np.testing.assert_allclose(runs["mesh4"]["ce_sharded"], runs["jax"]["ce"], rtol=1e-5)


def test_sharded_train_step_matches_unsharded(runs):
    p = runs["mesh4"]
    np.testing.assert_allclose(p["ce_sharded"], p["ce_plain"], rtol=1e-5)
    assert p["ce_sharded"][-1] < p["ce_sharded"][0]


def test_tp_weight_and_zero1_moment_are_shards(runs):
    """``w_gate`` ([d, d_ff], ``P(None, "model")``) keeps half its columns on
    a rank; its ZeRO-1 moment (``P("data", "model")``) half of those rows."""
    (g0, g1), (l0, l1), (m0, m1) = runs["mesh4"]["w_gate_shapes"]
    assert (l0, l1) == (g0, g1 // 2)
    assert (m0, m1) == (g0 // 2, g1 // 2)


def test_residual_spec_constrains_without_changing_the_loss(runs):
    plain, seqpar = runs["mesh4"]["loss_seqpar"]
    np.testing.assert_allclose(seqpar, plain, rtol=1e-6)


def test_gqa_heads_cut_finer_than_kv_groups(runs):
    """A 4-way model axis over 4 query heads and 2 KV groups: the loss and
    every gradient of the sharded step equal the plain step's within 1e-5."""
    plain, sharded, grad_rel = runs["mesh4"]["gqa_split"]
    np.testing.assert_allclose(sharded, plain, rtol=1e-6)
    assert grad_rel < 1e-5, grad_rel


def test_vocab_parallel_cross_entropy(runs):
    """``logsumexp_pick`` on vocab-sharded logits (``Shard(2)`` over
    ``model``): the all-reduced partial sums equal the plain ops."""
    rng = np.random.default_rng(0)
    inp = _inputs(rng)
    x = torch.from_numpy(inp["ce_logits"]).requires_grad_()
    labels = torch.from_numpy(inp["ce_labels"])
    lse = torch.logsumexp(x, -1)
    picked = torch.gather(x, -1, labels[..., None])[..., 0]
    (lse - picked).sum().backward()
    p = runs["mesh4"]
    np.testing.assert_allclose(p["ce_lse"], lse.detach().numpy(), rtol=1e-6)
    np.testing.assert_array_equal(p["ce_picked"], picked.detach().numpy())
    np.testing.assert_allclose(p["ce_grad"], x.grad.numpy(), atol=1e-6)


# --------------------------------------------------------------------------- #
# compression, ring matmuls, GPipe, elastic restore                            #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("policy", ["int8", "topk", "none"])
def test_compressed_allreduce_matches_jax(runs, policy):
    j = runs["jax"]
    for r, got in enumerate(runs["compress8"]):
        np.testing.assert_allclose(got[f"{policy}_mean"], j[f"{policy}_mean"], atol=1e-6)
        np.testing.assert_allclose(got[f"{policy}_err"], j[f"{policy}_err"][r], atol=1e-6)
    if policy == "int8":
        for got in runs["compress8"]:
            np.testing.assert_allclose(got["int8_mean2"], j["int8_mean2"], atol=1e-6)


def test_error_feedback_shrinks_the_bias(runs):
    """As the JAX package's test: the first int8 mean is within 0.05 of the
    true mean, the average of two rounds (the second carrying the first's
    error) closer."""
    true = _inputs(np.random.default_rng(0))["comp_g"].mean(0)
    got = runs["compress8"][0]
    e1 = np.abs(got["int8_mean"] - true).max()
    e2 = np.abs((got["int8_mean"] + got["int8_mean2"]) / 2 - true).max()
    assert e1 < 0.05 and e2 < e1, (e1, e2)
    assert np.abs(runs["compress8"][0]["topk_mean"]).max() > 0


@pytest.mark.parametrize("name", ["ag", "rs"])
def test_ring_matmul_matches_jax(runs, name):
    p, j = runs["mesh4"], runs["jax"]
    for part in ("y", "dx", "dw"):
        key = f"{name}_{part}"
        np.testing.assert_allclose(p[key], j[key], rtol=1e-5,
                                   atol=1e-5 * np.abs(j[key]).max(), err_msg=key)


def test_gpipe_forward(runs):
    p = runs["mesh4"]
    np.testing.assert_array_equal(p["pipe_out"], p["pipe_seq"])
    np.testing.assert_allclose(p["pipe_out"], runs["jax"]["pipe_out"], atol=1e-6)


def test_gpipe_gradient_matches_jax(runs):
    np.testing.assert_allclose(runs["mesh4"]["pipe_grad"], runs["jax"]["pipe_grad"], atol=1e-6)


def test_elastic_restore_is_bit_exact(runs):
    """Saved from a (4 data, 1 model) mesh, restored onto (2, 2): every
    leaf equal to the original, ``w_gate`` split over the 2-way model axis."""
    step, same, n, model_size, local_cols, cols = runs["mesh4"]["elastic"]
    assert step == 7 and same and n == len(runs["mesh4"]["elastic_paths"]) > 0
    assert model_size == 2 and local_cols == cols // 2


def test_elastic_restore_carries_the_admm_state(runs):
    """An ADMM ``TrainState`` (params, ZeRO-1 moments, Z and U with their
    ``None`` leaves) after a step on (4, 1), saved and restored onto (2, 2)
    with Z / U placed like the params: bit-exact, its next step (a Z/U
    update) equal to the next step of the same state moved onto (2, 2)
    without the save, and within 1e-5 of the next step on (4, 1)."""
    at, exact, placed, has_none, n_updates, next_equal, metrics_equal = \
        runs["mesh4"]["elastic_admm"]
    assert at == 1 and exact and placed and has_none and n_updates == 1
    assert next_equal and metrics_equal
    on_b, moved_b, on_a = runs["mesh4"]["elastic_admm_losses"]
    assert on_b == moved_b
    np.testing.assert_allclose(on_b, on_a, rtol=1e-5)
    np.testing.assert_allclose(*runs["mesh4"]["elastic_admm_residual"], rtol=1e-5)
