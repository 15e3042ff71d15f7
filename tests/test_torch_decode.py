"""The plan-compiled decoder in the port against the JAX package, on the CPU,
at the smoke config of qwen2.5-3b (2 layers, d_model 128, 4 heads, 2 KV
heads, head_dim 32, d_ff 256, vocab 256, f32).

Both packages get the same params -- drawn from a numpy seed in the nested
``init_lm`` layout and handed to the port through ``lm_params_from_numpy``
-- and the same tokens.  What is held:

* the decoder graphs: node names, ops, inputs and epilogue programs of both
  phases equal the JAX package's, before and after ``optimize``, and fusion
  shortens the plans;
* prefill logits within 1e-4 of the JAX prefill plan and of the port's own
  ``forward`` (the bound of the JAX package's ``test_prefill_parity``);
* greedy decode over ``PagedKVCache`` on the port's reference and kernel
  backends (plain kernel versions here): exactly the JAX package's tokens;
* the port's ``PagedKVCache`` against the JAX one under the same sequence
  of operations;
* one bf16 case: prefill logits of each backend within 1 bf16 ulp of
  max|logit| of the JAX plan on the same backend.
"""

import dataclasses
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jsmoke_config
from repro.core.graph import compile_plan as jcompile_plan
from repro.core.graph.passes import optimize as joptimize
from repro.models import attention as jattn
from repro.models import ffn as jffn
from repro.models.transformer import forward as jforward
from repro.models.transformer_graph import build_decoder_graph as jbuild
from repro.serving.kvcache import CacheFullError as JCacheFullError
from repro.serving.kvcache import PagedKVCache as JPagedKVCache
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.convert import lm_params_from_numpy, params_from_numpy
from repro_torch.core.graph import compile_plan
from repro_torch.core.graph.passes import optimize
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import ffn as tffn
from repro_torch.models.transformer import forward, init_lm
from repro_torch.models.transformer_graph import build_decoder_graph, decoder_cache_spec
from repro_torch.serving import CacheFullError, PagedKVCache

PHASES = ("prefill", "decode")


def numpy_lm(cfg, seed=0):
    """An ``init_lm``-shaped param tree of f32 numpy arrays: weights scaled
    by 1/sqrt(fan-in), small random biases, norm scales around 1."""
    rng = np.random.default_rng(seed)
    d, dh = cfg.d_model, cfg.resolved_head_dim
    vp = cfg.vocab_padded

    def lin(i, o, bias=False):
        p = {"w": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)}
        if bias:
            p["b"] = (rng.standard_normal(o) * 0.1).astype(np.float32)
        return p

    def norm():
        return {"scale": rng.uniform(0.5, 1.5, d).astype(np.float32)}

    layers = [{
        "norm1": norm(),
        "attn": {
            "w_q": lin(d, cfg.n_heads * dh, cfg.qkv_bias),
            "w_k": lin(d, cfg.n_kv_heads * dh, cfg.qkv_bias),
            "w_v": lin(d, cfg.n_kv_heads * dh, cfg.qkv_bias),
            "w_o": lin(cfg.n_heads * dh, d),
        },
        "norm2": norm(),
        "ffn": {"w_gate": lin(d, cfg.d_ff), "w_up": lin(d, cfg.d_ff), "w_down": lin(cfg.d_ff, d)},
    } for _ in range(cfg.n_layers)]
    return {
        "embed": {"table": (rng.standard_normal((vp, d)) * 0.02).astype(np.float32)},
        "layers": layers,
        "final_norm": norm(),
        "lm_head": lin(d, vp),
    }


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


@pytest.fixture(scope="module")
def lm():
    jcfg, cfg = jsmoke_config("qwen2.5-3b"), smoke_config("qwen2.5-3b")
    pnp = numpy_lm(cfg)
    jparams = _tree_map(jnp.asarray, pnp)
    params = lm_params_from_numpy(pnp, device="cpu")
    jgraphs = {ph: joptimize(jbuild(jparams, jcfg, phase=ph)) for ph in PHASES}
    graphs = {ph: optimize(build_decoder_graph(params, cfg, phase=ph)) for ph in PHASES}
    return dict(jcfg=jcfg, cfg=cfg, pnp=pnp, jparams=jparams, params=params,
                jgraphs=jgraphs, graphs=graphs)


def _plans(graphs, backend):
    return {ph: compile_plan(g, backend=backend, device="cpu") for ph, g in graphs.items()}


def _jplans(graphs, backend):
    return {ph: jcompile_plan(g, backend=backend, interpret=backend != "reference")
            for ph, g in graphs.items()}


def _node_view(g):
    return [(n.name, n.op, tuple(n.inputs),
             tuple((k, v) for k, v in sorted(n.attrs.items()) if k != "idx"))
            for n in g.nodes]


def _param_view(g):
    return {name: {k: tuple(v.shape) for k, v in p.items()} for name, p in g.params.items()}


# --------------------------------------------------------------------------- #
# configs and params                                                           #
# --------------------------------------------------------------------------- #


def test_isolation_walk_reaches_the_decode_slice():
    """``tests/test_torch_isolation.py`` imports every module of the package
    with JAX blocked; the decode slice's modules are among them."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert {"repro_torch.configs", "repro_torch.configs.registry",
            "repro_torch.models.transformer", "repro_torch.models.transformer_graph",
            "repro_torch.serving.scheduler", "repro_torch.serving.kvcache",
            "repro_torch.kernels.flash_attention", "repro_torch.kernels.fused_ffn"} <= names


def test_configs_copy_the_jax_package_values():
    from repro.configs.registry import ARCH_IDS as JARCH_IDS
    from repro.configs.registry import get_config as jget_config

    assert ARCH_IDS == JARCH_IDS and len(ARCH_IDS) == 10
    assert dataclasses.asdict(get_config("qwen2.5-3b")) == dataclasses.asdict(
        jget_config("qwen2.5-3b"))
    assert dataclasses.asdict(smoke_config("qwen2.5-3b")) == dataclasses.asdict(
        jsmoke_config("qwen2.5-3b"))
    assert dataclasses.asdict(get_config("mamba2-1.3b")) == dataclasses.asdict(
        jget_config("mamba2-1.3b"))
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_params_carry_bf16_bit_exactly():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16)
    t = params_from_numpy({"n": {"w": a, "i": np.arange(3, dtype=np.int64)}}, device="cpu")
    assert t["n"]["w"].dtype == torch.bfloat16 and t["n"]["i"].dtype == torch.int32
    assert np.array_equal(t["n"]["w"].view(torch.int16).numpy(), a.view(np.int16))
    # from a JAX bf16 array too (numpy dtype kind 'V')
    j = jnp.asarray(a)
    assert np.asarray(j).dtype.kind == "V"
    tj = params_from_numpy({"n": {"w": j}}, device="cpu")["n"]["w"]
    assert torch.equal(tj, t["n"]["w"])


def test_lm_params_from_numpy_keeps_the_tree(lm):
    params, pnp = lm["params"], lm["pnp"]
    assert isinstance(params["layers"], list) and len(params["layers"]) == 2
    assert params["layers"][1]["attn"]["w_q"]["b"].dtype == torch.float32
    np.testing.assert_array_equal(params["lm_head"]["w"].numpy(), pnp["lm_head"]["w"])
    bf = lm_params_from_numpy(_tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), pnp), "cpu")
    assert bf["layers"][0]["ffn"]["w_up"]["w"].dtype == torch.bfloat16


def test_init_lm_draws_the_jax_layout_from_a_generator(lm):
    cfg = lm["cfg"]
    p = init_lm(torch.Generator().manual_seed(0), cfg)
    want = _tree_map(lambda a: tuple(a.shape), lm["pnp"])
    assert _tree_map(lambda t: tuple(t.shape), p) == want
    assert p["layers"][0]["attn"]["w_q"]["b"].abs().sum() == 0  # biases start at zero
    again = init_lm(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(again["lm_head"]["w"], p["lm_head"]["w"])


# --------------------------------------------------------------------------- #
# graphs                                                                       #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("phase", PHASES)
def test_decoder_graphs_equal_the_jax_package(lm, phase):
    raw = build_decoder_graph(lm["params"], lm["cfg"], phase=phase)
    jraw = jbuild(lm["jparams"], lm["jcfg"], phase=phase)
    assert raw.inputs == jraw.inputs and raw.outputs == jraw.outputs
    assert _node_view(raw) == _node_view(jraw)
    g, jg = lm["graphs"][phase], lm["jgraphs"][phase]
    assert _node_view(g) == _node_view(jg)
    assert _param_view(g) == _param_view(jg)
    assert len(g.nodes) == 9 * lm["cfg"].n_layers + 2
    # the last down projection absorbs the residual add and the final norm
    assert g.nodes[-2].attrs["epilogue"] == (("add", 1), ("norm_rms", "e0", 1e-6))


def test_decoder_graphs_fuse(lm):
    for phase in PHASES:
        raw = build_decoder_graph(lm["params"], lm["cfg"], phase=phase)
        unfused = len(compile_plan(raw, backend="reference", device="cpu").steps)
        fused = len(compile_plan(lm["graphs"][phase], backend="reference", device="cpu").steps)
        assert fused < unfused, (phase, fused, unfused)


def test_decoder_cache_spec_and_memory_estimate(lm):
    cfg = lm["cfg"]
    assert decoder_cache_spec(cfg) == {"n_layers": 2, "n_kv_heads": 2, "head_dim": 32}
    plans = _plans(lm["graphs"], "kernel")
    tok = torch.zeros((2, 9), dtype=torch.int32)
    mem = plans["prefill"].memory_estimate(tok, tok, torch.full((2,), 9, dtype=torch.int32))
    assert mem["out_shapes"][0] == (2, 9, cfg.vocab_padded)
    assert mem["out_shapes"][1] == (2, 9, 64)
    assert mem["param_bytes"] == sum(
        a.nbytes for a in [x for p in lm["graphs"]["prefill"].params.values() for x in p.values()]
        for a in [a.numpy()])
    ctx = torch.zeros((2, 2, 16, 2, 32))
    mem = plans["decode"].memory_estimate(tok[:, :1], tok[:, :1], ctx, ctx,
                                          torch.full((2,), 5, dtype=torch.int32))
    assert mem["out_shapes"][0] == (2, 1, cfg.vocab_padded)
    assert mem["peak_activation_bytes"] > 0


# --------------------------------------------------------------------------- #
# prefill parity                                                               #
# --------------------------------------------------------------------------- #


def _prefill_inputs(cfg, b=2, s=9):
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return tok, pos, np.full((b,), s, np.int32)


@pytest.fixture(scope="module")
def jax_prefill_logits(lm):
    tok, pos, lens = _prefill_inputs(lm["cfg"])
    plans = _jplans(lm["jgraphs"], "reference")
    outs = plans["prefill"](lm["jgraphs"]["prefill"].params, jnp.asarray(tok),
                            jnp.asarray(pos), jnp.asarray(lens))
    return [np.asarray(o) for o in outs]


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_prefill_parity(lm, jax_prefill_logits, backend):
    cfg = lm["cfg"]
    tok, pos, lens = _prefill_inputs(cfg)
    outs = _plans(lm["graphs"], backend)["prefill"](lm["graphs"]["prefill"].params, tok, pos,
                                                    lens)
    logits = outs[0].numpy()
    assert np.max(np.abs(logits - jax_prefill_logits[0])) <= 1e-4
    for got, want in zip(outs[1:], jax_prefill_logits[1:]):  # the per-layer k / v
        assert np.max(np.abs(got.numpy() - want)) <= 1e-4
    want, _ = forward(lm["params"], cfg, torch.from_numpy(tok))
    assert np.max(np.abs(logits[..., : cfg.vocab] - want.numpy()[..., : cfg.vocab])) <= 1e-4


def test_forward_matches_jax_forward(lm):
    tok, _, _ = _prefill_inputs(lm["cfg"], b=1, s=6)
    got, aux = forward(lm["params"], lm["cfg"], torch.from_numpy(tok))
    want, _ = jforward(lm["jparams"], lm["jcfg"], jnp.asarray(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert float(aux) == 0.0


def test_prefill_rows_past_their_length_stay_finite_and_do_not_leak(lm):
    """A padded prompt: rows past the length attend to the valid prefix
    only, and the valid rows equal an unpadded prefill's."""
    cfg = lm["cfg"]
    plans = _plans(lm["graphs"], "kernel")
    tok, pos, _ = _prefill_inputs(cfg, b=1, s=9)
    full = plans["prefill"](lm["graphs"]["prefill"].params, tok, pos, np.array([9], np.int32))
    short = plans["prefill"](lm["graphs"]["prefill"].params, tok[:, :5], pos[:, :5],
                             np.array([5], np.int32))
    padded = plans["prefill"](lm["graphs"]["prefill"].params, tok, pos, np.array([5], np.int32))
    assert torch.isfinite(padded[0]).all()
    torch.testing.assert_close(padded[0][:, :5], short[0], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(padded[0][:, 5:], full[0][:, 5:])


# --------------------------------------------------------------------------- #
# greedy decode over the paged cache                                           #
# --------------------------------------------------------------------------- #


def _greedy_plan(cfg, graphs, plans, prompt, steps, *, cache_cls, asarray):
    """The serving pipeline by hand (as the JAX package's test drives it):
    one prefill, then per-token decode over gathered cache spans."""
    spec = decoder_cache_spec(cfg)
    g, dh = spec["n_kv_heads"], spec["head_dim"]
    cache = cache_cls(num_pages=16, page_size=4, **spec)
    cache.allocate(0)
    n0 = len(prompt)
    outs = plans["prefill"](graphs["prefill"].params, asarray([prompt]),
                            asarray([list(range(n0))]), asarray([n0]))
    kvs = [np.asarray(o[0], np.float32).reshape(n0, g, dh) for o in outs[1:]]
    cache.append(0, np.stack(kvs[0::2], 1), np.stack(kvs[1::2], 1))
    got = [int(np.argmax(np.asarray(outs[0], np.float32)[0, -1]))]
    for _ in range(steps - 1):
        n = cache.length(0)
        cache.ensure_capacity(0, n + 1)
        k_ctx, v_ctx, lens = cache.gather([0], min_tokens=n + 1)
        outs = plans["decode"](graphs["decode"].params, asarray([[got[-1]]]), asarray([[n]]),
                               asarray(k_ctx), asarray(v_ctx), asarray(lens))
        kvs = [np.asarray(o[0], np.float32).reshape(1, g, dh) for o in outs[1:]]
        cache.append(0, np.stack(kvs[0::2], 1), np.stack(kvs[1::2], 1))
        got.append(int(np.argmax(np.asarray(outs[0], np.float32)[0, -1])))
    cache.release(0)
    cache.check_invariants()
    assert cache.free_pages == cache.num_pages
    return got


def _t(x):
    return torch.as_tensor(np.asarray(x, np.int32) if np.asarray(x).dtype.kind in "iu"
                           else np.asarray(x))


def _greedy_forward(params, cfg, prompt, steps):
    seq = list(prompt)
    for _ in range(steps):
        logits, _ = forward(params, cfg, torch.tensor([seq], dtype=torch.int32))
        seq.append(int(logits[0, -1].argmax()))
    return seq[len(prompt):]


@pytest.fixture(scope="module")
def golden(lm):
    """The JAX package's tokens: its kernel-backend plans (Pallas in
    interpret mode) over its own paged cache."""
    prompt = [int(t) for t in np.random.default_rng(2).integers(0, lm["cfg"].vocab, 5)]
    want = _greedy_plan(lm["jcfg"], lm["jgraphs"], _jplans(lm["jgraphs"], "kernel"), prompt, 4,
                        cache_cls=JPagedKVCache, asarray=lambda a: jnp.asarray(np.asarray(a)))
    return prompt, want


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_greedy_decode_golden(lm, golden, backend):
    prompt, want = golden
    got = _greedy_plan(lm["cfg"], lm["graphs"], _plans(lm["graphs"], backend), prompt, 4,
                       cache_cls=PagedKVCache, asarray=_t)
    assert got == want, (backend, got, want)
    assert _greedy_forward(lm["params"], lm["cfg"], prompt, 4) == want
    assert sum(tops.kernel_launch_counts().values()) == 0  # plain versions on the CPU


def test_decode_step_logits_match_jax_plan(lm):
    """One decode step over a gathered span with two sequences of different
    lengths: logits and fresh k/v within 1e-4 of the JAX decode plan's."""
    cfg = lm["cfg"]
    rng = np.random.default_rng(3)
    spec = decoder_cache_spec(cfg)
    k_ctx = rng.standard_normal((2, 2, 8, 2, 32)).astype(np.float32)
    v_ctx = rng.standard_normal((2, 2, 8, 2, 32)).astype(np.float32)
    lens = np.array([7, 3], np.int32)
    tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    pos = lens[:, None].copy()
    assert spec["n_layers"] == k_ctx.shape[1]
    want = _jplans(lm["jgraphs"], "reference")["decode"](
        lm["jgraphs"]["decode"].params, *map(jnp.asarray, (tok, pos, k_ctx, v_ctx, lens)))
    for backend in ("reference", "kernel"):
        got = _plans(lm["graphs"], backend)["decode"](lm["graphs"]["decode"].params, tok, pos,
                                                      k_ctx, v_ctx, lens)
        for g_, w_ in zip(got, want):
            assert np.max(np.abs(g_.numpy() - np.asarray(w_))) <= 1e-4, backend


# --------------------------------------------------------------------------- #
# model modules                                                                #
# --------------------------------------------------------------------------- #


def test_gqa_prefill_and_decode_step_match_jax(lm):
    cfg, jcfg = lm["cfg"], lm["jcfg"]
    ap, jap = lm["params"]["layers"][0]["attn"], lm["jparams"]["layers"][0]["attn"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5)).copy()
    y, cache = tattn.gqa_prefill(ap, cfg, torch.from_numpy(x), torch.from_numpy(pos), 8)
    jy, jcache = jattn.gqa_prefill(jap, jcfg, jnp.asarray(x), jnp.asarray(pos), 8, impl="full")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    for k in ("k", "v", "pos"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), rtol=1e-5, atol=1e-5)
    xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    y2, c2 = tattn.gqa_decode_step(ap, cfg, torch.from_numpy(xt), cache)
    jy2, jc2 = jattn.gqa_decode_step(jap, jcfg, jnp.asarray(xt), jcache)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(c2["pos"].numpy(), np.asarray(jc2["pos"]))
    np.testing.assert_allclose(c2["k"].numpy(), np.asarray(jc2["k"]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_mlp_matches_jax(lm, fused):
    fp, jfp = lm["params"]["layers"][1]["ffn"], lm["jparams"]["layers"][1]["ffn"]
    x = np.random.default_rng(5).standard_normal((2, 3, 128)).astype(np.float32)
    got = tffn.mlp(fp, torch.from_numpy(x), fused=fused)
    want = jffn.mlp(jfp, jnp.asarray(x), fused=fused)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_packed_modes_wait_for_the_pbcsr_slice(lm):
    """The PBCSR slice has landed: the packed modes run (held against the
    JAX package in ``tests/test_torch_decode_pruned.py``); an unknown mode
    still raises, and a MoE config's ``init_lm`` builds the JAX package's
    tree (the zoo is ported)."""
    from repro_torch.models.layers import linear

    p = {"values": torch.ones(1, 1, 8, 8), "block_rows": torch.zeros(1, 1, dtype=torch.int32)}
    for mode in ("bsr", "bsr_xla"):
        assert torch.equal(linear(p, torch.ones(1, 8), mode=mode), torch.full((1, 8), 8.0))
    with pytest.raises(ValueError, match="unknown linear mode"):
        linear(p, torch.ones(1, 8), mode="sparse")
    import jax

    from repro.models.transformer import init_lm as jinit_lm

    mcfg = dataclasses.replace(lm["cfg"], family="moe",
                               moe=jsmoke_config("deepseek-v2-lite-16b").moe)
    got = init_lm(torch.Generator(), mcfg)
    want = jax.eval_shape(lambda: jinit_lm(jax.random.PRNGKey(0), mcfg))
    assert _tree_map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), got) == \
        _tree_map(lambda a: (tuple(a.shape), str(a.dtype)), want)
    assert "moe" in got["layers"][1] and "ffn" in got["layers"][0]


# --------------------------------------------------------------------------- #
# the paged KV-cache                                                           #
# --------------------------------------------------------------------------- #


def _drive_cache(cls, err_cls, script, seed):
    rng = np.random.default_rng(seed)
    cache = cls(num_pages=6, page_size=3, n_layers=2, n_kv_heads=2, head_dim=4)
    log = []
    for op, *args in script:
        if op == "alloc":
            cache.allocate(args[0])
        elif op == "append":
            t = args[1]
            k = rng.standard_normal((t, 2, 2, 4)).astype(np.float32)
            v = rng.standard_normal((t, 2, 2, 4)).astype(np.float32)
            try:
                cache.append(args[0], k, v)
                log.append(("ok", cache.length(args[0])))
            except err_cls:
                log.append(("full", cache.length(args[0])))
        elif op == "release":
            log.append(("released", cache.release(args[0])))
        elif op == "gather":
            k_ctx, v_ctx, lens = cache.gather(args[0], min_tokens=args[1])
            log.append(("gather", k_ctx, v_ctx, lens))
        cache.check_invariants()
        log.append(("occ", cache.occupancy(), tuple(cache.block_table(s)
                                                    for s in sorted(cache.sequences()))))
    return log


CACHE_SCRIPTS = {
    "grow-release": [("alloc", 0), ("append", 0, 4), ("alloc", 1), ("append", 1, 2),
                     ("gather", [0, 1], 5), ("append", 0, 1), ("release", 0),
                     ("append", 1, 5), ("gather", [1], 0)],
    "pressure": [("alloc", 0), ("append", 0, 12), ("alloc", 1), ("append", 1, 9),
                 ("append", 1, 6), ("release", 0), ("append", 1, 6), ("gather", [1], 18)],
}


@pytest.mark.parametrize("name", sorted(CACHE_SCRIPTS))
def test_paged_kv_cache_matches_jax_package(name):
    got = _drive_cache(PagedKVCache, CacheFullError, CACHE_SCRIPTS[name], 6)
    want = _drive_cache(JPagedKVCache, JCacheFullError, CACHE_SCRIPTS[name], 6)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y


# --------------------------------------------------------------------------- #
# bf16                                                                         #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_prefill_logits_bf16_within_one_ulp_of_jax(lm, backend):
    """The smoke config in bf16 (the dtype of the full-width model): the
    same bf16 params (carried bit-exactly) and tokens through both packages'
    prefill plans on the same backend.  Each op rounds to bf16 where the
    JAX package's does -- the in-tile residual add of the kernel backend on
    the f32 accumulator, the tail of the last down projection, rmsnorm's
    cast before the scale -- so only a summation order may differ: 1 bf16
    ulp of max|logit|.  (The two backends differ from each other by more:
    the reference backend rounds the GEMM output before the residual add.)"""
    jcfg = dataclasses.replace(lm["jcfg"], dtype="bfloat16")
    cfg = dataclasses.replace(lm["cfg"], dtype="bfloat16")
    pbf = _tree_map(lambda a: a.astype(ml_dtypes.bfloat16), lm["pnp"])
    jparams = _tree_map(jnp.asarray, pbf)
    params = lm_params_from_numpy(pbf, device="cpu")
    assert params["layers"][0]["attn"]["w_q"]["w"].dtype == torch.bfloat16
    jg = joptimize(jbuild(jparams, jcfg, phase="prefill"))
    g = optimize(build_decoder_graph(params, cfg, phase="prefill"))
    tok, pos, lens = _prefill_inputs(cfg)
    jplan = jcompile_plan(jg, backend=backend, interpret=backend == "kernel")
    want = np.asarray(jplan(jg.params, *map(jnp.asarray, (tok, pos, lens)))[0])
    got = compile_plan(g, backend=backend, device="cpu")(g.params, tok, pos, lens)[0]
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()[..., : cfg.vocab]
    want = want.astype(np.float32)[..., : cfg.vocab]
    tol = 2.0 ** (math.floor(math.log2(float(np.max(np.abs(want))))) - 7)
    assert np.max(np.abs(got - want)) <= tol, (np.max(np.abs(got - want)), tol)
