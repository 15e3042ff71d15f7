"""The block-pruned decoder in the port against the JAX package, on the CPU,
at the smoke config of qwen2.5-3b (2 layers, d_model 128, 4 heads of 32,
f32).

The path is the compiler's: the dense decoder graph of each phase goes
through ``optimize`` with ``Block(0.5, bm=32, bn=32)`` masks on every
``q_i`` / ``o_i`` linear, which ``substitute_sparse`` rewrites to
``sparse_linear(format="pbcsr")``.  With ``balanced=True`` the reorder is
the identity and the plans keep 9 x L + 2 nodes; with ``balanced=False`` it
is not, so each pruned node gets its "unperm" glue node and rope stays a
node of its own.  Both packages get the same params (a numpy tree in
``init_lm``'s layout) and compute their own masks.  What is held, in both
modes:

* masks, graphs (nodes, attrs, param keys and shapes) and packed payloads
  equal the JAX package's;
* prefill logits and k / v, and one decode step, within 1e-4 of the JAX
  reference-backend plans, on both of the port's backends (the kernel
  backend runs the plain versions here), and prefill within 1e-4 of the
  port's plain ``forward`` on the masked-dense params;
* greedy tokens over the paged cache equal the JAX plans' and the plain
  ``forward`` loop's.

Beside it, the model stack's packed modes: a ``cfg.prune.enabled``
``init_lm`` from the JAX package, carried over, through the port's
``forward`` (``bsr_xla`` / ``colpack_xla``) against the JAX ``forward``;
``linear`` in all four packed modes against the JAX ``linear``; the port's
own pruned ``init_lm`` in the JAX layout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import PruneConfig as JPruneConfig
from repro.configs.registry import smoke_config as jsmoke_config
from repro.core.graph.passes import optimize as joptimize
from repro.core.pruning import Block as JBlock
from repro.core.pruning import project as jproject
from repro.core.sparse import formats as jformats
from repro.core.sparse import reorder as jreorder
from repro.models import layers as jlayers
from repro.models.transformer import forward as jforward
from repro.models.transformer import init_lm as jinit_lm
from repro.models.transformer_graph import build_decoder_graph as jbuild
from repro.serving.kvcache import PagedKVCache as JPagedKVCache
from repro_torch.configs import PruneConfig, smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.graph.passes import optimize
from repro_torch.core.pruning import Block, project
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as tlayers
from repro_torch.models.transformer import forward, init_lm
from repro_torch.models.transformer_graph import build_decoder_graph
from repro_torch.serving import PagedKVCache
from test_torch_decode import (
    PHASES,
    _greedy_forward,
    _greedy_plan,
    _jplans,
    _node_view,
    _param_view,
    _plans,
    _prefill_inputs,
    _t,
    _tree_map,
    numpy_lm,
)

BM = BN = 32


def _pruned_names(g):
    return [n.name for n in g.nodes if n.op == "linear" and n.name.startswith(("q_", "o_"))]


def _masked_params(params, masks):
    """The port's param tree with every pruned q / o weight masked."""
    out = _tree_map(lambda t: t, params)
    for name, m in masks.items():
        kind, i = name.split("_")
        key = "w_q" if kind == "q" else "w_o"
        layer = out["layers"][int(i)]["attn"]
        layer[key] = {**layer[key], "w": layer[key]["w"] * m}
    return out


@pytest.fixture(scope="module", params=[True, False], ids=["balanced", "unbalanced"])
def pruned(request):
    balanced = request.param
    jcfg, cfg = jsmoke_config("qwen2.5-3b"), smoke_config("qwen2.5-3b")
    pnp = numpy_lm(cfg, seed=11)
    jparams = _tree_map(jnp.asarray, pnp)
    params = lm_params_from_numpy(pnp, device="cpu")
    graphs, jgraphs, masks = {}, {}, {}
    for ph in PHASES:
        g = build_decoder_graph(params, cfg, phase=ph)
        jg = jbuild(jparams, jcfg, phase=ph)
        names = _pruned_names(g)
        st = {k: Block(0.5, bm=BM, bn=BN, balanced=balanced) for k in names}
        jst = {k: JBlock(0.5, bm=BM, bn=BN, balanced=balanced) for k in names}
        masks[ph] = {k: project(g.params[k]["w"], st[k])[1] for k in names}
        jmasks = {k: jproject(jg.params[k]["w"], jst[k])[1] for k in names}
        for k in names:
            np.testing.assert_array_equal(masks[ph][k].numpy(), np.asarray(jmasks[k]))
        graphs[ph] = optimize(g, masks[ph], st)
        jgraphs[ph] = joptimize(jg, jmasks, jst)
    return dict(balanced=balanced, cfg=cfg, jcfg=jcfg, params=params, graphs=graphs,
                jgraphs=jgraphs, masked=_masked_params(params, masks["prefill"]))


def test_block_pruned_graphs_equal_jax(pruned):
    cfg = pruned["cfg"]
    for ph in PHASES:
        g, jg = pruned["graphs"][ph], pruned["jgraphs"][ph]
        assert _node_view(g) == _node_view(jg)
        assert _param_view(g) == _param_view(jg)
        pb = [n for n in g.nodes if n.op == "sparse_linear" and n.attrs["format"] == "pbcsr"]
        assert len(pb) == 2 * cfg.n_layers
        glue = [n for n in g.nodes if n.name.endswith("_unperm")]
        assert len(g.nodes) == 9 * cfg.n_layers + 2 + 2 * len(glue)
        if pruned["balanced"]:
            assert not glue and all(n.attrs["bands"] == ((0, 4, 2),) for n in pb)
            assert {n.name for n in pb} == {f"{p}_{i}" for p in ("q_rope", "res1")
                                          for i in range(cfg.n_layers)}
        else:
            assert glue  # this seed's reorder is not the identity
        for n in pb:
            p, jp = g.params[n.name], jg.params[n.name]
            np.testing.assert_array_equal(p["values"].numpy(), np.asarray(jp["values"]))
            np.testing.assert_array_equal(p["block_rows"].numpy(), np.asarray(jp["block_rows"]))
            assert p["block_rows"].dtype == torch.int32
        for n in glue:
            jn = next(m for m in jg.nodes if m.name == n.name)
            np.testing.assert_array_equal(np.asarray(n.attrs["idx"]), np.asarray(jn.attrs["idx"]))


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_block_pruned_prefill_matches_jax(pruned, backend):
    cfg = pruned["cfg"]
    tok, pos, lens = _prefill_inputs(cfg)
    jg = pruned["jgraphs"]["prefill"]
    want = _jplans(pruned["jgraphs"], "reference")["prefill"](
        jg.params, *map(jnp.asarray, (tok, pos, lens)))
    g = pruned["graphs"]["prefill"]
    got = _plans(pruned["graphs"], backend)["prefill"](g.params, tok, pos, lens)
    for a, b in zip(got, want):
        assert np.max(np.abs(a.numpy() - np.asarray(b))) <= 1e-4
    fwd, _ = forward(pruned["masked"], cfg, torch.from_numpy(tok))
    v = cfg.vocab
    assert np.max(np.abs(got[0].numpy()[..., :v] - fwd.numpy()[..., :v])) <= 1e-4


def test_block_pruned_decode_step_matches_jax(pruned):
    cfg = pruned["cfg"]
    rng = np.random.default_rng(3)
    k_ctx = rng.standard_normal((2, 2, 8, 2, 32)).astype(np.float32)
    v_ctx = rng.standard_normal((2, 2, 8, 2, 32)).astype(np.float32)
    lens = np.array([6, 2], np.int32)
    tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    pos = lens[:, None].copy()
    jg = pruned["jgraphs"]["decode"]
    want = _jplans(pruned["jgraphs"], "reference")["decode"](
        jg.params, *map(jnp.asarray, (tok, pos, k_ctx, v_ctx, lens)))
    g = pruned["graphs"]["decode"]
    for backend in ("reference", "kernel"):
        got = _plans(pruned["graphs"], backend)["decode"](g.params, tok, pos, k_ctx, v_ctx, lens)
        for a, b in zip(got, want):
            assert np.max(np.abs(a.numpy() - np.asarray(b))) <= 1e-4, backend


def test_block_pruned_greedy_tokens_equal_jax(pruned):
    cfg = pruned["cfg"]
    prompt = [int(t) for t in np.random.default_rng(5).integers(0, cfg.vocab, 6)]
    want = _greedy_plan(pruned["jcfg"], pruned["jgraphs"], _jplans(pruned["jgraphs"],
                                                                   "reference"),
                        prompt, 5, cache_cls=JPagedKVCache,
                        asarray=lambda a: jnp.asarray(np.asarray(a)))
    for backend in ("reference", "kernel"):
        got = _greedy_plan(cfg, pruned["graphs"], _plans(pruned["graphs"], backend), prompt, 5,
                           cache_cls=PagedKVCache, asarray=_t)
        assert got == want, (backend, got, want)
    assert _greedy_forward(pruned["masked"], cfg, prompt, 5) == want
    assert tops.kernel_launch_counts()["bsr_matmul"] == 0  # plain versions on the CPU


# --------------------------------------------------------------------------- #
# the model stack's packed modes                                               #
# --------------------------------------------------------------------------- #


def _prune_cfgs(mode):
    jcfg = dataclasses.replace(jsmoke_config("qwen2.5-3b"),
                               prune=JPruneConfig(enabled=True, exec_mode=mode, sparsity=0.5))
    cfg = dataclasses.replace(smoke_config("qwen2.5-3b"),
                              prune=PruneConfig(enabled=True, exec_mode=mode, sparsity=0.5))
    return jcfg, cfg


@pytest.mark.parametrize("mode", ["bsr_xla", "colpack_xla"])
def test_pruned_init_lm_forward_matches_jax(mode):
    """The JAX package's pruned ``init_lm`` (block-pruned q / o under a bsr
    mode, column-pruned FFN always), carried over: the port's ``forward``
    runs the same packed params as the JAX ``forward`` does."""
    jcfg, cfg = _prune_cfgs(mode)
    jparams = jinit_lm(jax.random.PRNGKey(0), dataclasses.replace(jcfg, dtype="float32"))
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
                           jparams)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    attn = params["layers"][0]["attn"]
    assert ("block_rows" in attn["w_q"]) == (mode == "bsr_xla")
    assert "kept" in params["layers"][0]["ffn"]["w_gate"]
    # random (non-zero) biases on the packed q so the bias path is exercised
    rng = np.random.default_rng(0)
    for lp, jlp in zip(params["layers"], jparams["layers"]):
        if "b" in lp["attn"]["w_q"]:
            b = (rng.standard_normal(lp["attn"]["w_q"]["b"].shape) * 0.1).astype(np.float32)
            lp["attn"]["w_q"]["b"] = torch.from_numpy(b)
            jlp["attn"]["w_q"]["b"] = jnp.asarray(b)
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (2, 7)).astype(np.int32)
    got, _ = forward(params, cfg, torch.from_numpy(tok))
    want, _ = jforward(jparams, jcfg, jnp.asarray(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["bsr_xla", "colpack_xla"])
def test_port_pruned_init_lm_has_the_jax_layout(mode):
    jcfg, cfg = _prune_cfgs(mode)
    want = jax.eval_shape(lambda: jinit_lm(jax.random.PRNGKey(0), jcfg))
    got = init_lm(torch.Generator().manual_seed(0), cfg)
    dt = {torch.bfloat16: "bfloat16", torch.float32: "float32", torch.int32: "int32"}
    assert _tree_map(lambda t: (tuple(t.shape), dt[t.dtype]), got) == jax.tree.map(
        lambda s: (tuple(s.shape), str(s.dtype)), want)
    # the deterministic stripes equal the JAX package's
    jreal = jinit_lm(jax.random.PRNGKey(0), jcfg)
    for lp, jlp in zip(got["layers"], jreal["layers"]):
        for key in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(lp["ffn"][key]["kept"].numpy(),
                                          np.asarray(jlp["ffn"][key]["kept"]))
        if mode == "bsr_xla":
            for key in ("w_q", "w_o"):
                np.testing.assert_array_equal(lp["attn"][key]["block_rows"].numpy(),
                                              np.asarray(jlp["attn"][key]["block_rows"]))


def _packed_params(rng, d_in, d_out, mode):
    """JAX ``init_pruned_linear`` shapes with real content: a Block-packed
    weight with bands (bsr modes) or a column pack (colpack modes)."""
    w = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    b = (rng.standard_normal(d_out) * 0.1).astype(np.float32)
    if mode.startswith("bsr"):
        _, m = jproject(jnp.asarray(w), JBlock(0.5, bm=16, bn=16, balanced=False))
        bmask = np.asarray(jnp.any(m.reshape(d_in // 16, 16, d_out // 16, 16) != 0, axis=(1, 3)))
        plan = jreorder.plan_reorder(bmask, max_bands=4, bm=16, bn=16)
        wp = np.asarray(jreorder.apply_column_perm(jnp.asarray(w), plan.order, 16))
        mp = np.asarray(jreorder.apply_column_perm(m, plan.order, 16))
        f = jformats.PBCSR.from_dense(jnp.asarray(wp), jnp.asarray(mp), 16, 16)
        return {"values": np.asarray(f.values), "block_rows": np.asarray(f.block_rows), "b": b,
                "bands": tuple((bd.start, bd.stop, bd.count) for bd in plan.bands)}
    kept = np.sort(rng.choice(d_in, d_in // 2, replace=False)).astype(np.int32)
    return {"values": w[kept], "kept": kept, "b": b}


@pytest.mark.parametrize("mode", ["bsr", "bsr_xla", "colpack", "colpack_xla"])
def test_packed_linear_modes_match_jax(mode):
    rng = np.random.default_rng(8)
    pnp = _packed_params(rng, 64, 96, mode)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jp = {k: v if k == "bands" else jnp.asarray(v) for k, v in pnp.items()}
    p = lm_params_from_numpy({"lin": pnp}, device="cpu")["lin"]
    if mode.startswith("bsr"):
        assert p["bands"] == pnp["bands"] and len(p["bands"]) > 1
        assert p["block_rows"].dtype == torch.int32
    got = tlayers.linear(p, torch.from_numpy(x), mode=mode, activation="gelu")
    want = jlayers.linear(jp, jnp.asarray(x), mode=mode, activation="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_lm_params_from_numpy_carries_packed_bf16_values():
    rng = np.random.default_rng(9)
    pnp = _packed_params(rng, 32, 32, "bsr")
    pnp["values"] = pnp["values"].astype(ml_dtypes.bfloat16)
    p = lm_params_from_numpy({"layers": [{"w_q": pnp}]}, device="cpu")["layers"][0]["w_q"]
    assert p["values"].dtype == torch.bfloat16 and p["values"].dim() == 4
    assert np.array_equal(p["values"].view(torch.int16).numpy(), pnp["values"].view(np.int16))
    assert isinstance(p["bands"], tuple) and all(isinstance(c, int) for b in p["bands"]
                                                  for c in b)
