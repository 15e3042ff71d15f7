"""The port's builders, pruning recipe and pass pipeline against the JAX
package's, app by app, on the CPU.

Both sides get the same params, drawn from a numpy seed (the JAX builder
fixes the structure, then its weights are replaced -- its ``jax.random``
draws are stubbed while it builds, since compiling them per shape costs
tens of seconds and the values are thrown away; the port's builder takes
the same arrays through ``params=``).  Checks: the
builders agree node for node, ``app_masks`` agrees bit for bit, the
optimized graphs have the same nodes, ops and attrs and the same param keys
and shapes, params agree to 1e-6, and ``PassManager`` reports the same
per-pass node counts.  Coloring runs at base 16 so its ``glob_fc1`` linear
is wide enough to be column-pruned (a ``colcompact`` node).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import PassContext as JPassContext
from repro.core.sparse import formats as jformats
from repro.core.graph import PassManager as JPassManager
from repro.models import cnn as jcnn
from repro_torch.core.graph import PassContext, PassManager
from repro_torch.core.sparse import formats as tformats
from repro_torch.models import cnn as tcnn

APPS = ["style_transfer", "coloring", "super_resolution"]
BASES = {"style_transfer": 8, "coloring": 16, "super_resolution": 8}
#: the attrs the optimized graphs must agree on
ATTRS = ("format", "activation", "epilogue", "steps", "stride", "kind", "fn", "factor",
         "axis", "k_full", "padding")


def numpy_params(g, seed=0):
    """Params of ``g``'s shapes from a numpy seed: fan-in-scaled weights,
    non-trivial norm statistics (so folding does real work)."""
    rng = np.random.default_rng(seed)
    out = {}
    for node in g.nodes:
        p = g.params.get(node.name)
        if not p:
            continue
        out[node.name] = {}
        for key, v in p.items():
            shape = tuple(v.shape)
            if key == "w":
                fan = int(np.prod(shape[1:])) if len(shape) == 4 else shape[0]
                arr = rng.standard_normal(shape) / np.sqrt(fan)
            elif key in ("scale", "var"):
                arr = rng.uniform(0.5, 1.5, shape)
            else:
                arr = rng.standard_normal(shape) * 0.1
            out[node.name][key] = arr.astype(np.float32)
    return out


_CACHE = {}


def jax_structure(app, base):
    """The JAX app graph, its weight draws stubbed with zeros."""
    normal = jax.random.normal
    jax.random.normal = lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype)
    try:
        return jcnn.APPS[app](jax.random.PRNGKey(0), base=base)
    finally:
        jax.random.normal = normal


def app_case(app):
    """(JAX graph, port graph, JAX masks/ctx/optimized, numpy params), built
    once per app per test process."""
    if app not in _CACHE:
        base = BASES[app]
        jg = jax_structure(app, base)
        pnp = numpy_params(jg)
        jg = dataclasses.replace(
            jg, params={n: {k: jnp.asarray(v) for k, v in p.items()} for n, p in pnp.items()}
        )
        jmasks, jstructs = jcnn.app_masks(jg, app, sparsity=0.5)
        jctx = JPassContext(masks=jmasks, structures=jstructs)
        jgo = JPassManager().run(jg, jctx)
        tg = tcnn.APPS[app](base=base, params=pnp, device="cpu")
        _CACHE[app] = dict(jg=jg, tg=tg, jmasks=jmasks, jctx=jctx, jgo=jgo)
    return _CACHE[app]


def _norm_attr(v):
    if isinstance(v, np.ndarray):
        return ("arr", v.tolist())
    if isinstance(v, (list, tuple)):
        return tuple(_norm_attr(x) for x in v)
    return v


def _port_optimized(app):
    c = app_case(app)
    masks, structs = tcnn.app_masks(c["tg"], app, sparsity=0.5)
    ctx = PassContext(masks=masks, structures=structs)
    return PassManager().run(c["tg"], ctx), ctx


@pytest.mark.parametrize("app", APPS)
def test_builders_agree_node_for_node(app):
    c = app_case(app)
    jg, tg = c["jg"], c["tg"]
    assert [(n.name, n.op, n.inputs) for n in tg.nodes] == \
        [(n.name, n.op, n.inputs) for n in jg.nodes]
    for jn, tn in zip(jg.nodes, tg.nodes):
        assert _norm_attr(tn.attrs) == _norm_attr(jn.attrs), tn.name
    assert (tg.inputs, tg.outputs) == (jg.inputs, jg.outputs)
    assert {n: {k: tuple(v.shape) for k, v in p.items()} for n, p in tg.params.items()} == \
        {n: {k: tuple(v.shape) for k, v in p.items()} for n, p in jg.params.items()}


@pytest.mark.parametrize("app", APPS)
def test_app_masks_bit_identical(app):
    c = app_case(app)
    masks, structs = tcnn.app_masks(c["tg"], app, sparsity=0.5)
    assert set(masks) == set(c["jmasks"]) and masks
    for name, jm in c["jmasks"].items():
        tm = masks[name].numpy()
        assert tm.shape == jm.shape and tm.dtype == np.asarray(jm).dtype, name
        assert np.array_equal(tm, np.asarray(jm)), name
        js = c["jctx"].structures[name]
        assert type(structs[name]).__name__ == type(js).__name__
        assert dataclasses.asdict(structs[name]) == dataclasses.asdict(js)


@pytest.mark.parametrize("app", APPS)
def test_optimized_graph_and_params_match(app):
    c = app_case(app)
    jgo = c["jgo"]
    tgo, _ = _port_optimized(app)
    assert [(n.name, n.op, n.inputs) for n in tgo.nodes] == \
        [(n.name, n.op, n.inputs) for n in jgo.nodes]
    for jn, tn in zip(jgo.nodes, tgo.nodes):
        for key in ATTRS:
            assert _norm_attr(tn.attrs.get(key)) == _norm_attr(jn.attrs.get(key)), (tn.name, key)
    assert sorted(tgo.params) == sorted(jgo.params)
    for node, jp in jgo.params.items():
        tp = tgo.params[node]
        assert sorted(tp) == sorted(jp), node
        for key, jv in jp.items():
            jv, tv = np.asarray(jv), tp[key].numpy()
            assert tv.shape == jv.shape and tv.dtype == jv.dtype, (node, key)
            if key == "kept":
                assert np.array_equal(tv, jv), node
            else:
                np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6, err_msg=f"{node}.{key}")
    formats = {n.attrs.get("format") for n in tgo.nodes}
    assert "channelcompact" in formats
    if app == "coloring":
        assert "colcompact" in formats


@pytest.mark.parametrize("app", APPS)
def test_pass_manager_stats_match(app):
    c = app_case(app)
    _, ctx = _port_optimized(app)
    assert list(ctx.stats) == list(c["jctx"].stats)
    for name, js in c["jctx"].stats.items():
        ts = ctx.stats[name]
        assert (ts.nodes_before, ts.nodes_after, ts.changed) == \
            (js.nodes_before, js.nodes_after, js.changed), name
    assert PassManager().summary(ctx) == JPassManager().summary(c["jctx"])


@pytest.mark.parametrize("fmt", ["ColumnCompact", "ChannelCompact"])
def test_compact_formats_match_jax(fmt):
    rng = np.random.default_rng(5)
    w = rng.standard_normal((12, 10)).astype(np.float32)
    mask = np.ones_like(w)
    if fmt == "ColumnCompact":
        mask[[1, 4, 5, 9], :] = 0
    else:
        mask[:, [0, 3, 7]] = 0
    jf = getattr(jformats, fmt).from_dense(jnp.asarray(w * mask), jnp.asarray(mask))
    tf = getattr(tformats, fmt).from_dense(torch.from_numpy(w * mask), torch.from_numpy(mask))
    assert np.array_equal(tf.kept.numpy(), np.asarray(jf.kept))
    assert tf.kept.dtype == torch.int32
    np.testing.assert_array_equal(tf.values.numpy(), np.asarray(jf.values))
    np.testing.assert_array_equal(tf.to_dense().numpy(), w * mask)
    assert tf.nbytes == jf.nbytes and tf.shape == jf.shape
