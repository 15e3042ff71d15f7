"""Every zoo family's sharded train and decode steps in the port against its
unsharded steps and the JAX package's sharded steps, on the CPU, across
processes.

The port runs as 4 gloo ranks (``tests/_torch_mesh_ranks.py``, case
``zoo4``) behind a file rendezvous: for the smoke config of each of the ten
``ARCH_IDS`` families, under ``DEFAULT_RULES`` and ``FSDP_RULES``, on (2, 2)
and (4, 1) ``(data, model)`` meshes,

* one sharded forward + backward (``train_loop._value_and_grad``) against
  the unsharded one;
* a sharded ``prefill`` of every decoder family (the prompt and a VLM's
  patch embeddings cut over ``data``) against the unsharded one: its
  logits, every cache leaf, and each leaf's placements and local shape,
  which must be those the dry run gives a decode cell's caches
  (``sharding.cache_pspecs``: batch over ``data``, sequence, heads or
  channels over ``model``);
* ``DECODE_STEPS`` sharded decode steps from that prefill's caches
  (whisper, which has no prefill: from its encoder and a decode step a
  prompt token, the caches placed by ``cache_pspecs``), against the
  unsharded steps' logits, with every returned cache leaf's placements and
  local shape after each step;
* a windowed GQA layer's steps on a ring cache cut over ``model``;
* ``Engine.generate`` on DTensor params (``ranks.ENGINE_ARCHS``, (2, 2),
  ``DEFAULT_RULES``) against the unsharded ``Engine``'s greedy tokens;
* ``RequestScheduler`` on DTensor params (``ranks.SCHED_CELLS``, (2, 2)):
  ``SCHED_REQUESTS`` requests over ``ZOO_BATCH`` slots against the
  unsharded scheduler's tokens, with every cache leaf's placements and
  local rows at each tick.

The JAX reference runs in one subprocess on (2, 2) meshes of
``AxisType.Auto`` axes (see ``tests/test_torch_distributed.py``): the
deepseek-v2 smoke configs' loss and gradients under ``FSDP_RULES``; the
qwen2.5-3b, deepseek-v2-lite and mamba2 decode steps from its own prefill,
its caches placed by its ``_cache_pspecs``; and the jitted ``lm.prefill`` on
params placed by ``param_pspecs`` for ``JAX_PREFILL``; the last two under
both rule sets; and its ``RequestScheduler`` on params placed by
``param_pspecs`` (``DEFAULT_RULES``) for ``ranks.SCHED_ARCHS``.  Both packages read the same params: ``numpy_tree``'s
arrays in the JAX layout, carried into the port by
``convert.lm_params_from_numpy`` and saved as a checkpoint that both
restore.

Tolerances: losses within 1e-5 (relative) of the unsharded port's and of
JAX's sharded step; every gradient leaf within 1e-4 x its max |unsharded|
(and of JAX's); prefill logits and cache leaves, and decode logits, within
1e-5 x max |reference| of the unsharded port's and of JAX's sharded step
(the same f32 ops, summed in other orders and, where the cache is cut over
its sequence, combined by a log-sum-exp all-reduce); ``pos`` and the
greedy tokens equal (a token may differ only where the plain logits' top
two are within 1e-5 x max |logits|).
"""

import jax
import numpy as np
import pytest

from repro.configs.registry import smoke_config as jsmoke_config
from repro.models import encdec as jencdec
from repro.models import transformer as jlm
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.training import checkpoint
from test_torch_distributed import _finish, _start_jax, _start_ranks
from test_torch_zoo_models import numpy_tree

import _torch_mesh_ranks as ranks

RTOL = 1e-5
GRAD_TOL = 1e-4
#: the ranks' wall limit: 40 sharded train and 40 sharded decode cells, each
#: paying DTensor's first sharding propagation of its shapes, take 80-130 s
#: on 8 shared CPU cores (``tests/test_torch_distributed.py`` allows its
#: smaller groups 120 s)
WALL_S = 300
MESHES = [f"{a}x{b}" for a, b in ranks.ZOO_MESHES]
CELLS = [(arch, mesh, rules) for arch in ARCH_IDS for mesh in MESHES for rules in ranks.ZOO_RULES]
JAX_TRAIN = ("deepseek-v2-lite-16b", "deepseek-v2-236b")
JAX_DECODE = ("qwen2.5-3b", "deepseek-v2-lite-16b", "mamba2-1.3b")
JAX_PREFILL = ("qwen2.5-3b", "deepseek-v2-lite-16b", "mamba2-1.3b", "recurrentgemma-9b",
               "paligemma-3b")
#: every decoder family (whisper has no prefill in either package)
PREFILL_CELLS = [c for c in CELLS if not smoke_config(c[0]).is_encdec]

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
m22 = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                    devices=jax.devices()[:4])
is_p = lambda x: isinstance(x, P)

def place(tree, specs):
    return jax.tree.map(lambda s, a: jax.device_put(a, NamedSharding(m22, s)), specs, tree,
                        is_leaf=is_p)

def rows(a):
    return jax.device_put(a, NamedSharding(m22, P("data", *[None] * (a.ndim - 1))))

def restore(arch):
    cfg = smoke_config(arch)
    model = get_model(cfg)
    params, _ = checkpoint.restore(io + "/params_" + arch,
                                   jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    return cfg, model, params

for arch in %(train)r:
    cfg, model, params = restore(arch)
    params = place(params, param_pspecs(params, FSDP_RULES))
    b = SyntheticPipeline(cfg, batch=%(batch)d, seq=%(seq)d + 1, seed=0).next()
    with m22:
        (loss, _), grads = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(
            params, {k: rows(v) for k, v in b.items()})
    out[arch + "_loss"] = np.asarray(float(loss))
    for i, g in enumerate(jax.tree.leaves(grads)):
        out[arch + "_grad%%d" %% i] = np.asarray(g, np.float32)

prefill = jax.jit(lm.prefill, static_argnums=(1, 3))
for arch in %(decode)r:
    cfg, model, plain = restore(arch)
    _, caches = prefill(plain, cfg, inp[arch + "_prompt"], %(max_len)d)
    specs = _maybe_replicate_batch(_cache_pspecs(caches, P("data")), caches, m22)
    step = jax.jit(model.decode_step)
    for name, rules in (("default", None), ("fsdp", FSDP_RULES)):
        params = place(plain, param_pspecs(plain, rules))
        c = place(caches, specs)
        logits = []
        with m22:
            for t in range(%(steps)d):
                lg, c = step(params, {"tokens_t": rows(inp[arch + "_steps"][:, t:t + 1])}, c)
                logits.append(np.asarray(lg))
        out[arch + "_" + name + "_logits"] = np.stack(logits)

for arch in %(prefill)r:
    cfg, model, plain = restore(arch)
    pe = inp.get(arch + "_patch_embeds")
    kw = {} if pe is None else {"patch_embeds": rows(pe)}
    for name, rules in (("default", None), ("fsdp", FSDP_RULES)):
        params = place(plain, param_pspecs(plain, rules))
        with m22:
            lg, _ = prefill(params, cfg, rows(inp[arch + "_prompt"]), %(max_len)d, **kw)
        out[arch + "_" + name + "_prefill_logits"] = np.asarray(lg, np.float32)

from repro.serving.engine import Engine, Request, RequestScheduler
for arch in %(sched)r:
    cfg, model, plain = restore(arch)
    sched = RequestScheduler(Engine(model, place(plain, param_pspecs(plain)),
                                    batch_size=%(batch)d, max_len=%(max_len)d))
    new = inp[arch + "_sched_new"]
    reqs = [Request(j, inp[arch + "_sched_prompt%%d" %% j], int(n)) for j, n in enumerate(new)]
    for r in reqs:
        sched.submit(r)
    with m22:
        sched.run()
    tokens = np.full((len(reqs), %(sched_new)d), -1, np.int32)
    for r in reqs:
        tokens[r.rid, :len(r.generated)] = r.generated
    out[arch + "_sched_tokens"] = tokens
np.savez(io + "/jax.npz", **out)
""" % dict(train=JAX_TRAIN, decode=JAX_DECODE, prefill=JAX_PREFILL, sched=ranks.SCHED_ARCHS,
           batch=ranks.ZOO_BATCH, seq=ranks.ZOO_SEQ, max_len=ranks.ZOO_MAX_LEN,
           steps=ranks.DECODE_STEPS, sched_new=ranks.SCHED_MAX_NEW)


def _numpy_params(arch):
    """``numpy_tree``'s arrays in the JAX package's layout of ``arch``'s smoke
    config (as ``tests/test_torch_zoo_models.zoo_case`` draws them)."""
    cfg = jsmoke_config(arch)
    init = jencdec.init_encdec if cfg.is_encdec else jlm.init_lm
    return numpy_tree(jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg)), seed=len(arch))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    io_dir = tmp_path_factory.mktemp("zoo")
    inputs = {}
    for arch in ARCH_IDS:
        checkpoint.save(str(io_dir / f"params_{arch}"), 0,
                        lm_params_from_numpy(_numpy_params(arch), device="cpu"))
        if arch in JAX_DECODE + JAX_PREFILL:
            for k, v in ranks.zoo_decode_inputs(smoke_config(arch)).items():
                inputs[f"{arch}_{k}"] = v
        if arch in ranks.SCHED_ARCHS:
            reqs = ranks.zoo_sched_requests(smoke_config(arch))
            for j, (prompt, _) in enumerate(reqs):
                inputs[f"{arch}_sched_prompt{j}"] = prompt
            inputs[f"{arch}_sched_new"] = np.asarray([n for _, n in reqs])
    np.savez(io_dir / "inputs.npz", **inputs)
    _finish({"jax": _start_jax(io_dir, JAX_REF), "zoo4": _start_ranks("zoo4", 4, io_dir)},
            wall_s=WALL_S)
    return {"jax": dict(np.load(io_dir / "jax.npz")),
            "port": dict(np.load(io_dir / "zoo4_rank0.npz"))}


def _within(got, ref, tol):
    """``|got - ref| <= tol * max|ref|``, elementwise."""
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, err


# --------------------------------------------------------------------------- #
# the train step                                                               #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch,mesh,rules", CELLS)
def test_sharded_forward_backward_matches_unsharded(runs, arch, mesh, rules):
    """The loss within 1e-5 of the unsharded port's, every gradient leaf
    within 1e-4 x its max |unsharded| (the MoE experts under ``FSDP_RULES``
    included: gathered for use, reduce-scattered back)."""
    p = runs["port"]
    tag = f"{arch}_{mesh}_{rules}"
    np.testing.assert_allclose(p[f"{tag}_loss"], p[f"{arch}_loss"], rtol=RTOL)
    err, gmax = p[f"{tag}_grad_err"], p[f"{arch}_grad_max"]
    assert len(err) == len(gmax) == len(p[f"{arch}_paths"]) > 0
    worst = int(np.argmax(err / np.maximum(gmax, 1e-30)))
    assert err[worst] <= GRAD_TOL * gmax[worst], (p[f"{arch}_paths"][worst], err[worst],
                                                 gmax[worst])


@pytest.mark.parametrize("arch", JAX_TRAIN)
def test_deepseek_fsdp_step_matches_jax_sharded(runs, arch):
    """Under ``FSDP_RULES`` on (2, 2): the loss within 1e-5 of JAX's
    sharded step, every gradient leaf within 1e-4 x its max |JAX|."""
    p, j = runs["port"], runs["jax"]
    tag = f"{arch}_2x2_fsdp"
    np.testing.assert_allclose(p[f"{tag}_loss"], j[f"{arch}_loss"], rtol=RTOL)
    n = len(p[f"{arch}_paths"])
    assert n == sum(k.startswith(f"{arch}_grad") for k in j)
    for i in range(n):
        _within(p[f"{tag}_grad{i}"], j[f"{arch}_grad{i}"], GRAD_TOL)


# --------------------------------------------------------------------------- #
# decode                                                                       #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch,mesh,rules", CELLS)
def test_sharded_decode_matches_unsharded(runs, arch, mesh, rules):
    """Each step's logits within 1e-5 x max |logits| of the unsharded
    steps', and after each step every cache leaf (GQA / MLA / Mamba-2 /
    RG-LRU state, ``pos``, whisper's self-attention caches and its cross
    K/V) in the placements and local shape it was given."""
    p = runs["port"]
    tag = f"{arch}_{mesh}_{rules}"
    got, ref = p[f"{tag}_logits"], p[f"{arch}_logits"]
    assert got.shape == ref.shape and got.shape[0] == ranks.DECODE_STEPS
    _within(got, ref, RTOL)
    kept = p[f"{tag}_kept"]
    assert kept.shape == (ranks.DECODE_STEPS,) and kept.all()


@pytest.mark.parametrize("rules", ranks.ZOO_RULES)
@pytest.mark.parametrize("arch", JAX_DECODE)
def test_sharded_decode_matches_jax_sharded(runs, arch, rules):
    p, j = runs["port"], runs["jax"]
    _within(p[f"{arch}_2x2_{rules}_logits"], j[f"{arch}_{rules}_logits"], RTOL)


# --------------------------------------------------------------------------- #
# prefill and the Engine                                                       #
# --------------------------------------------------------------------------- #


def check_prefill(p, tag):
    """The sharded prefill's logits and every cache leaf within 1e-5 x max
    |plain|, ``pos`` equal, each leaf in its ``cache_pspecs`` placements and
    local shape (``ranks._prefill_check``'s record of cell ``tag``)."""
    assert p[f"{tag}_prefill_err"] <= RTOL, p[f"{tag}_prefill_err"]
    err, placed = p[f"{tag}_prefill_cache_err"], p[f"{tag}_prefill_placed"]
    assert len(err) == len(placed) > 0
    assert err.max() <= RTOL, err
    assert placed.all(), np.flatnonzero(~placed)


@pytest.mark.parametrize("arch,mesh,rules", PREFILL_CELLS)
def test_sharded_prefill_matches_unsharded(runs, arch, mesh, rules):
    check_prefill(runs["port"], f"{arch}_{mesh}_{rules}")


@pytest.mark.parametrize("rules", ranks.ZOO_RULES)
@pytest.mark.parametrize("arch", JAX_PREFILL)
def test_sharded_prefill_matches_jax_sharded(runs, arch, rules):
    """On (2, 2): the logits within 1e-5 x max |logits| of the JAX
    package's jitted ``lm.prefill`` on params placed by ``param_pspecs``."""
    p, j = runs["port"], runs["jax"]
    got, ref = p[f"{arch}_2x2_{rules}_prefill_logits"], j[f"{arch}_{rules}_prefill_logits"]
    assert got.shape == ref.shape
    _within(got, ref, RTOL)


@pytest.mark.parametrize("arch", ranks.ENGINE_ARCHS)
def test_engine_on_the_mesh_matches_unsharded(runs, arch):
    """``Engine.generate`` on DTensor params ((2, 2), ``DEFAULT_RULES``)
    gives the unsharded engine's greedy tokens; at the first step where a
    row differs, the plain logits' top two are within 1e-5 x max |logits|
    (a near tie).  After each decode step every cache leaf is where it
    went in, in its ``cache_pspecs`` placements."""
    p = runs["port"]
    (plain, sharded), logits = p[f"{arch}_engine_tokens"], p[f"{arch}_engine_logits"]
    assert plain.shape == (ranks.ZOO_BATCH, ranks.ENGINE_STEPS) == sharded.shape
    differ = np.flatnonzero((plain != sharded).any(axis=0))
    if differ.size:
        t = differ[0]
        top2 = np.sort(logits[t], axis=-1)[:, -2:]
        rows = plain[:, t] != sharded[:, t]
        gap = (top2[:, 1] - top2[:, 0])[rows]
        assert (gap <= RTOL * np.abs(logits[t]).max()).all(), (t, gap)
    kept = p[f"{arch}_engine_kept"]
    assert kept.shape == (ranks.ENGINE_STEPS - 1,) and kept.all()


def check_tokens(got, ref, logits):
    """Each request's tokens ``got`` equal to ``ref`` (``[R, T]``, -1 past a
    request's end); at a request's first token that differs, the top two of
    the plain logits behind it (``logits [R, T, V]``) within 1e-5 x their
    max |logits| (a near tie)."""
    assert got.shape == ref.shape == logits.shape[:2]
    assert ((got == -1) == (ref == -1)).all()
    for r in np.flatnonzero((got != ref).any(axis=1)):
        t = np.flatnonzero(got[r] != ref[r])[0]
        top2 = np.sort(logits[r, t])[-2:]
        assert top2[1] - top2[0] <= RTOL * np.abs(logits[r, t]).max(), (r, t, top2)


@pytest.mark.parametrize("arch,rules", ranks.SCHED_CELLS)
def test_scheduler_on_the_mesh_matches_unsharded(runs, arch, rules):
    """``RequestScheduler`` over an ``Engine`` on DTensor params ((2, 2)):
    ``SCHED_REQUESTS`` requests over ``ZOO_BATCH`` slots, each request's
    greedy tokens those of the scheduler on the plain params (the near-tie
    rule), and every request served to its ``max_new``."""
    p = runs["port"]
    tokens = p[f"{arch}_sched_tokens"]
    assert (tokens >= 0).sum() == sum(n for _, n in ranks.zoo_sched_requests(smoke_config(arch)))
    check_tokens(p[f"{arch}_{rules}_sched_tokens"], tokens, p[f"{arch}_sched_logits"])
    assert p[f"{arch}_{rules}_sched_done"].all()


@pytest.mark.parametrize("arch", ranks.SCHED_ARCHS)
def test_scheduler_on_the_mesh_matches_jax_sharded(runs, arch):
    """The same requests through the JAX package's ``RequestScheduler`` on
    params placed by ``param_pspecs`` on (2, 2) (``DEFAULT_RULES``): the
    port's sharded scheduler gives its tokens (the near-tie rule, on the
    port's plain logits)."""
    p, j = runs["port"], runs["jax"]
    check_tokens(p[f"{arch}_default_sched_tokens"], j[f"{arch}_sched_tokens"],
                 p[f"{arch}_sched_logits"])


@pytest.mark.parametrize("arch,rules", ranks.SCHED_CELLS)
def test_scheduler_caches_stay_cut_over_the_mesh(runs, arch, rules):
    """At every tick of the sharded scheduler each cache leaf, as spliced
    and as the decode step returns it, has its ``cache_pspecs`` placements
    and ``ZOO_BATCH / 2`` local rows: no rank holds the batch whole, and
    slots were refilled mid-run (more ticks than one admission needs)."""
    p = runs["port"]
    placed, rows = p[f"{arch}_{rules}_sched_placed"], p[f"{arch}_{rules}_sched_rows"]
    assert placed.shape == rows.shape and len(placed) >= 2
    assert placed.all() and rows.all()


def test_windowed_gqa_cache_on_the_mesh(runs):
    """A GQA layer with a window of 8 slots (its ring cache cut 4 a rank over
    ``model``): each step's output within 1e-5 of the plain step's, the
    cache's placements kept (``pos`` stays batch-sharded)."""
    p = runs["port"]
    y = p["window_y"]
    _within(y[:, 1], y[:, 0], RTOL)
    assert p["window_kept"].all()
    assert set(p["window_cut"]) == {"(Shard(dim=0), Shard(dim=1))",
                                    "(Shard(dim=0), Replicate())"}
