"""The Mamba-2 and RG-LRU mixers tensor-parallel over ``model`` in the port
against its unsharded steps and the JAX package's sharded steps, on the
CPU, across processes.

The port runs as 4 gloo ranks (``tests/_torch_mesh_ranks.py``, case
``ssm4``): the mamba2-1.3b and recurrentgemma-9b smoke configs (8 heads of
32 channels; 128 RG-LRU channels), under ``DEFAULT_RULES`` and
``FSDP_RULES``, on (1, 4) and (2, 2) ``(data, model)`` meshes, so each rank
runs 2 or 4 heads or 32 or 64 channels (``sharding.on_mixer``):

* one sharded forward + backward against the unsharded one, each of the
  mixers' gradient leaves in its weight's placements and local shape;
* a sharded ``prefill`` against the unsharded one: the logits, every
  cache leaf, and each leaf's placements and local shape, which must be
  where the JAX package's ``_cache_pspecs`` places a decode cache (the
  Mamba-2 state by heads, ``h`` and the conv windows by channels:
  ``sharding.cache_pspecs``);
* ``DECODE_STEPS`` sharded decode steps from that prefill's caches,
  against the unsharded steps' logits, every cache leaf and weight in the
  placements and local shape it was given after each step.

The JAX reference runs in one subprocess on a (1, 4) mesh of
``AxisType.Auto`` axes (as ``tests/test_torch_distributed_zoo.py`` builds
its (2, 2) one): both families' loss and gradients and their decode steps
from its own prefill, under both rule sets.  Both packages read the same
params (``numpy_tree``'s arrays, saved as a checkpoint both restore).

Tolerances, as the zoo's: losses within 1e-5 (relative), every gradient
leaf within 1e-4 x its max |reference|, prefill logits and cache leaves
and decode logits within 1e-5 x max |reference|.  (The JAX package's
sharded prefill of both families is held in
``tests/test_torch_distributed_zoo.py``.)
"""

import numpy as np
import pytest

from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.training import checkpoint
from test_torch_distributed import _finish, _start_jax, _start_ranks
from test_torch_distributed_zoo import _numpy_params, _within, check_prefill

import _torch_mesh_ranks as ranks

RTOL = 1e-5
GRAD_TOL = 1e-4
#: the ranks' wall limit (the run takes ~40 s on 8 shared CPU cores)
WALL_S = 240
MESHES = [f"{a}x{b}" for a, b in ranks.SSM_MESHES]
CELLS = [(arch, mesh, rules) for arch in ranks.SSM_ARCHS for mesh in MESHES
         for rules in ranks.ZOO_RULES]

JAX_REF = """
import sys
import numpy as np
import jax
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

jax.devices()  # the backend first: launch.dryrun sets XLA_FLAGS at import
from repro.configs import smoke_config
from repro.data.pipeline import SyntheticPipeline
from repro.launch.dryrun import _cache_pspecs, _maybe_replicate_batch
from repro.models import get_model
from repro.models import transformer as lm
from repro.models.sharding import FSDP_RULES, param_pspecs
from repro.training import checkpoint

io = sys.argv[1]
inp = dict(np.load(io + "/inputs.npz"))
out = {}
m14 = jax.make_mesh((1, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                    devices=jax.devices()[:4])
is_p = lambda x: isinstance(x, P)

def place(tree, specs):
    return jax.tree.map(lambda s, a: jax.device_put(a, NamedSharding(m14, s)), specs, tree,
                        is_leaf=is_p)

def rows(a):
    return jax.device_put(a, NamedSharding(m14, P("data", *[None] * (a.ndim - 1))))

prefill = jax.jit(lm.prefill, static_argnums=(1, 3))
for arch in %(archs)r:
    cfg = smoke_config(arch)
    model = get_model(cfg)
    plain, _ = checkpoint.restore(io + "/params_" + arch,
                                  jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    b = SyntheticPipeline(cfg, batch=%(batch)d, seq=%(seq)d + 1, seed=0).next()
    _, caches = prefill(plain, cfg, inp[arch + "_prompt"], %(max_len)d)
    specs = _maybe_replicate_batch(_cache_pspecs(caches, P("data")), caches, m14)
    grad_fn = jax.jit(jax.value_and_grad(model.loss, has_aux=True))
    step = jax.jit(model.decode_step)
    for name, rules in (("default", None), ("fsdp", FSDP_RULES)):
        params = place(plain, param_pspecs(plain, rules))
        with m14:
            (loss, _), grads = grad_fn(params, {k: rows(v) for k, v in b.items()})
        tag = arch + "_" + name
        out[tag + "_loss"] = np.asarray(float(loss))
        for i, g in enumerate(jax.tree.leaves(grads)):
            out[tag + "_grad%%d" %% i] = np.asarray(g, np.float32)
        c = place(caches, specs)
        logits = []
        with m14:
            for t in range(%(steps)d):
                lg, c = step(params, {"tokens_t": rows(inp[arch + "_steps"][:, t:t + 1])}, c)
                logits.append(np.asarray(lg))
        out[tag + "_logits"] = np.stack(logits)
np.savez(io + "/jax.npz", **out)
""" % dict(archs=ranks.SSM_ARCHS, batch=ranks.ZOO_BATCH, seq=ranks.ZOO_SEQ,
           max_len=ranks.ZOO_MAX_LEN, steps=ranks.DECODE_STEPS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    io_dir = tmp_path_factory.mktemp("ssm")
    inputs = {}
    for arch in ranks.SSM_ARCHS:
        checkpoint.save(str(io_dir / f"params_{arch}"), 0,
                        lm_params_from_numpy(_numpy_params(arch), device="cpu"))
        for k, v in ranks.zoo_decode_inputs(smoke_config(arch)).items():
            inputs[f"{arch}_{k}"] = v
    np.savez(io_dir / "inputs.npz", **inputs)
    _finish({"jax": _start_jax(io_dir, JAX_REF), "ssm4": _start_ranks("ssm4", 4, io_dir)},
            wall_s=WALL_S)
    return {"jax": dict(np.load(io_dir / "jax.npz")),
            "port": dict(np.load(io_dir / "ssm4_rank0.npz"))}


@pytest.mark.parametrize("arch,mesh,rules", CELLS)
def test_tensor_parallel_forward_backward_matches_unsharded(runs, arch, mesh, rules):
    """The loss within 1e-5 of the unsharded port's, every gradient leaf
    within 1e-4 x its max |unsharded|, each of the mixers' in its weight's
    placements and local shape."""
    p = runs["port"]
    tag = f"{arch}_{mesh}_{rules}"
    np.testing.assert_allclose(p[f"{tag}_loss"], p[f"{arch}_loss"], rtol=RTOL)
    err, gmax = p[f"{tag}_grad_err"], p[f"{arch}_grad_max"]
    assert len(err) == len(gmax) == len(p[f"{arch}_paths"]) > 0
    worst = int(np.argmax(err / np.maximum(gmax, 1e-30)))
    assert err[worst] <= GRAD_TOL * gmax[worst], (p[f"{arch}_paths"][worst], err[worst],
                                                 gmax[worst])
    cut, mixer = p[f"{tag}_grad_cut"], np.char.find(p[f"{arch}_paths"], "['mixer']") >= 0
    assert cut.shape == err.shape and mixer.sum() > 0
    assert cut[mixer].all(), p[f"{arch}_paths"][mixer & ~cut]


@pytest.mark.parametrize("arch,mesh,rules", CELLS)
def test_sharded_prefill_matches_unsharded(runs, arch, mesh, rules):
    """The tensor-parallel prefill's logits and caches within 1e-5 x max
    |plain|, every leaf in its decode placements."""
    check_prefill(runs["port"], f"{arch}_{mesh}_{rules}")


@pytest.mark.parametrize("arch,mesh,rules", CELLS)
def test_tensor_parallel_decode_matches_unsharded(runs, arch, mesh, rules):
    """Each step's logits within 1e-5 x max |logits| of the unsharded
    steps'; after each step every cache leaf in the placements and local
    shape it was given, and the weights in theirs."""
    p = runs["port"]
    tag = f"{arch}_{mesh}_{rules}"
    got, ref = p[f"{tag}_logits"], p[f"{arch}_logits"]
    assert got.shape == ref.shape and got.shape[0] == ranks.DECODE_STEPS
    _within(got, ref, RTOL)
    kept = p[f"{tag}_kept"]
    assert kept.shape == (ranks.DECODE_STEPS,) and kept.all()
    assert p[f"{tag}_weights_kept"]


@pytest.mark.parametrize("rules", ranks.ZOO_RULES)
@pytest.mark.parametrize("arch", ranks.SSM_ARCHS)
def test_tensor_parallel_steps_match_jax_sharded(runs, arch, rules):
    """On (1, 4): the loss within 1e-5 of JAX's sharded step, every
    gradient leaf within 1e-4 x its max |JAX|, each decode step's logits
    within 1e-5 x max |logits| of JAX's."""
    p, j = runs["port"], runs["jax"]
    tag = f"{arch}_1x4_{rules}"
    np.testing.assert_allclose(p[f"{tag}_loss"], j[f"{arch}_{rules}_loss"], rtol=RTOL)
    n = len(p[f"{arch}_paths"])
    assert n == sum(k.startswith(f"{arch}_{rules}_grad") for k in j)
    for i in range(n):
        _within(p[f"{tag}_grad{i}"], j[f"{arch}_{rules}_grad{i}"], GRAD_TOL)
    _within(p[f"{tag}_logits"], j[f"{arch}_{rules}_logits"], RTOL)
