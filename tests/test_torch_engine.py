"""The forward-based serving path of the port against the JAX package, on
the CPU: the granite-3-2b and phi4-mini-3.8b configs, ``transformer.prefill``
/ ``decode_step``, ``get_model``, ``Engine`` and ``RequestScheduler``, the
decoder plans of the new archs, and the serve CLI's default path.

Decoders (f32): the smoke configs of qwen2.5-3b, granite-3-2b (tied
embeddings) and phi4-mini-3.8b, and ``phi4-narrow`` -- phi4's config with 2
layers, 3 query heads to 1 KV head, head dim 128, d_ff 256, vocab 256, the
grouping phi4 has at full width (24 / 8).  Both packages get the same
params, drawn from a numpy seed in the ``init_lm`` layout (``numpy_lm`` of
``tests/test_torch_decode.py``, without ``lm_head`` when tied).  What is
held:

* prefill logits and caches, and decode-step logits over several steps,
  at rtol = atol = 1e-4 (the bound of ``tests/test_torch_decode.py``);
* ``Engine.generate`` greedy tokens: exactly the JAX engine's;
* a 2x oversubscribed ``RequestScheduler`` run: every request's tokens and
  the returned list (the requests still in a slot) exactly the JAX
  scheduler's;
* the decoder plans of granite (tied) and of phi4-narrow: prefill and
  decode logits within 1e-4 of the JAX reference plans'.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.configs.registry import smoke_config as jsmoke_config
from repro.core.graph import compile_plan as jcompile_plan
from repro.core.graph.passes import optimize as joptimize
from repro.models import get_model as jget_model
from repro.models import transformer as jlm
from repro.models.transformer_graph import build_decoder_graph as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import RequestScheduler as JRequestScheduler
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.graph import compile_plan
from repro_torch.core.graph.passes import optimize
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import Model, attention, get_model
from repro_torch.models import transformer as tlm
from repro_torch.models.transformer_graph import build_decoder_graph
from repro_torch.serving import Engine, GenerationResult, Request, RequestScheduler
from test_torch_decode import _tree_map, numpy_lm

NEW = ("granite-3-2b", "phi4-mini-3.8b")
CASES = ("qwen2.5-3b", "granite-3-2b", "phi4-mini-3.8b", "phi4-narrow")
TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 32

#: phi4's grouping (3 query heads a KV group) and head dim at a small width
NARROW = dict(n_layers=2, d_model=128, n_heads=3, n_kv_heads=1, head_dim=128, d_ff=256,
              vocab=256, dtype="float32")


def _cfgs(case):
    if case == "phi4-narrow":
        return (dataclasses.replace(jget_config("phi4-mini-3.8b"), name=case, **NARROW),
                dataclasses.replace(get_config("phi4-mini-3.8b"), name=case, **NARROW))
    return jsmoke_config(case), smoke_config(case)


_CACHE = {}


def lm_case(case):
    """Both packages' config, model, params and engine for ``case``
    (built once per test process)."""
    if case not in _CACHE:
        jcfg, cfg = _cfgs(case)
        pnp = numpy_lm(cfg, seed=3)
        if cfg.tie_embeddings:
            del pnp["lm_head"]
        _CACHE[case] = dict(jcfg=jcfg, cfg=cfg, pnp=pnp, jparams=_tree_map(jnp.asarray, pnp),
                            params=lm_params_from_numpy(pnp, device="cpu"),
                            jmodel=jget_model(jcfg), model=get_model(cfg, device="cpu"))
    return _CACHE[case]


def _tokens(cfg, b, s, seed=4):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL)


# --------------------------------------------------------------------------- #
# configs                                                                      #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", NEW)
def test_configs_equal_the_jax_package(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(smoke_config(arch)) == dataclasses.asdict(jsmoke_config(arch))
    assert arch in ARCH_IDS


def test_full_width_shapes_of_the_new_decoders():
    g, p = get_config("granite-3-2b"), get_config("phi4-mini-3.8b")
    assert (g.resolved_head_dim, g.n_heads // g.n_kv_heads, g.tie_embeddings) == (64, 4, True)
    assert (p.resolved_head_dim, p.n_heads // p.n_kv_heads, p.tie_embeddings) == (128, 3, False)
    assert p.vocab_padded % 128 == 0 and p.vocab_padded >= 200064


# --------------------------------------------------------------------------- #
# model API                                                                    #
# --------------------------------------------------------------------------- #


def test_get_model_namespace_and_the_parts_not_ported():
    c = lm_case("granite-3-2b")
    model = c["model"]
    assert isinstance(model, Model) and model.cfg is c["cfg"]
    params = model.init(torch.Generator().manual_seed(0))
    assert "lm_head" not in params  # tied embeddings
    want = _tree_map(lambda a: tuple(a.shape), c["pnp"])
    assert _tree_map(lambda t: tuple(t.shape), params) == want
    # training is ported: ``loss`` is ``transformer.loss_fn`` on the config
    tok = _tokens(c["cfg"], 2, 9)
    batch = {"tokens": torch.from_numpy(tok[:, :-1]), "labels": torch.from_numpy(tok[:, 1:])}
    loss, metrics = model.loss(params, batch)
    want, _ = tlm.loss_fn(params, c["cfg"], batch)
    assert loss.ndim == 0 and bool(torch.isfinite(loss)) and loss.item() == want.item()
    assert metrics["ce"].item() == want.item() and metrics["aux"].item() == 0.0
    # the dry run's input specs are ported (held to JAX's in
    # tests/test_torch_sharding.py): meta tensors, no memory
    from repro_torch.configs.base import SHAPES

    step, specs, caches = model.input_specs(SHAPES["train_4k"])
    assert step == "train_step" and caches is None
    assert all(t.device.type == "meta" for t in specs.values())
    # the zoo is ported: a windowed (ring-buffer) cache is the JAX package's,
    # and get_model serves a MoE config
    from repro.models import attention as jattention

    ring = attention.init_kv_cache(c["cfg"], 1, 8, window=4)
    jring = jattention.init_kv_cache(c["jcfg"], 1, 8, window=4)
    assert {k: (tuple(t.shape), str(t.dtype)) for k, t in ring.items()} == {
        k: (tuple(a.shape), "torch." + str(a.dtype)) for k, a in jring.items()}
    mcfg = dataclasses.replace(c["cfg"], family="moe",
                               moe=jsmoke_config("deepseek-v2-lite-16b").moe)
    mmodel = get_model(mcfg, device="cpu")
    mparams = mmodel.init(torch.Generator().manual_seed(0))
    out = Engine(mmodel, mparams, batch_size=2, max_len=16).generate(
        torch.from_numpy(_tokens(mcfg, 2, 5)), 3)
    assert out.tokens.shape == (2, 3) and int(out.tokens.max()) < mcfg.vocab


@pytest.mark.parametrize("case", CASES)
def test_init_cache_matches_jax(case):
    c = lm_case(case)
    want = c["jmodel"].init_cache(2, MAX_LEN)
    got = c["model"].init_cache(2, MAX_LEN)
    assert len(got) == len(want) == c["cfg"].n_layers
    for g, w in zip(got, want):
        assert {k: tuple(t.shape) for k, t in g.items()} == {
            k: tuple(a.shape) for k, a in w.items()}
        assert g["k"].dtype == torch.float32 and g["pos"].dtype == torch.int32
        assert not g["k"].any() and not g["pos"].any()


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_steps_match_jax(case):
    c = lm_case(case)
    jcfg, cfg = c["jcfg"], c["cfg"]
    tok = _tokens(cfg, 2, 7)
    jlogits, jcaches = jlm.prefill(c["jparams"], jcfg, jnp.asarray(tok), MAX_LEN)
    logits, caches = tlm.prefill(c["params"], cfg, torch.from_numpy(tok), MAX_LEN)
    _close(logits, jlogits)
    for got, want in zip(caches, jcaches):
        _close(got["k"], want["k"])
        _close(got["v"], want["v"])
        assert got["pos"].tolist() == np.asarray(want["pos"]).tolist() == [7, 7]
    fwd, _ = tlm.forward(c["params"], cfg, torch.from_numpy(tok))
    torch.testing.assert_close(logits, fwd, **TOL)
    nxt = _tokens(cfg, 2, 4, seed=5)
    for t in range(nxt.shape[1]):
        step = nxt[:, t:t + 1]
        jlogits, jcaches = c["jmodel"].decode_step(c["jparams"], {"tokens_t": jnp.asarray(step)},
                                                   jcaches)
        logits, caches = c["model"].decode_step(c["params"], {"tokens_t": torch.from_numpy(step)},
                                                caches)
        assert tuple(logits.shape) == (2, 1, cfg.vocab_padded)
        _close(logits, jlogits)
    assert caches[0]["pos"].tolist() == [11, 11]


@pytest.mark.parametrize("case", CASES)
def test_engine_generate_greedy_tokens_equal_jax(case):
    c = lm_case(case)
    prompts = _tokens(c["cfg"], 3, 6, seed=6)
    want = JEngine(c["jmodel"], c["jparams"], batch_size=3, max_len=MAX_LEN).generate(
        jnp.asarray(prompts), 5)
    got = Engine(c["model"], c["params"], batch_size=3, max_len=MAX_LEN).generate(
        torch.from_numpy(prompts), 5)
    assert isinstance(got, GenerationResult) and got.tokens.shape == (3, 5)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


def _requests(cls, cfg, n, prompt_len=8, new_tokens=6, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        plen = int(rng.integers(4, prompt_len))
        out.append(cls(rid=rid, prompt=rng.integers(0, cfg.vocab, plen).astype(np.int32),
                       max_new=int(rng.integers(3, new_tokens))))
    return out


@pytest.mark.parametrize("case", CASES)
def test_request_scheduler_matches_jax(case):
    """Two slots, four requests: the same tokens for every request and the
    same returned list -- the requests still in their slots, so a finished
    request whose slot was refilled is not returned (the JAX behaviour)."""
    c = lm_case(case)
    jsched = JRequestScheduler(JEngine(c["jmodel"], c["jparams"], batch_size=2, max_len=MAX_LEN))
    sched = RequestScheduler(Engine(c["model"], c["params"], batch_size=2, max_len=MAX_LEN))
    jreqs, reqs = _requests(JRequest, c["jcfg"], 4), _requests(Request, c["cfg"], 4)
    for jr, r in zip(jreqs, reqs):
        jsched.submit(jr)
        sched.submit(r)
    jdone, done = jsched.run(), sched.run()
    assert [r.rid for r in done] == [r.rid for r in jdone]
    assert len(done) == 2 and all(r.done for r in done)  # 2 of the 4 were refilled
    assert [(r.generated, r.done) for r in reqs] == [(r.generated, r.done) for r in jreqs]
    assert all(len(r.generated) == r.max_new for r in reqs)


def test_engine_temperature_sampling_is_seeded():
    c = lm_case("qwen2.5-3b")
    prompts = torch.from_numpy(_tokens(c["cfg"], 2, 5))

    def gen(seed):
        return Engine(c["model"], c["params"], batch_size=2, max_len=MAX_LEN, temperature=1.0,
                      seed=seed).generate(prompts, 6).tokens

    a, b = gen(1), gen(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, gen(2))
    assert ((a >= 0) & (a < c["cfg"].vocab_padded)).all()
    with pytest.raises(ValueError, match="batch_size"):
        Engine(c["model"], c["params"], batch_size=3, max_len=MAX_LEN).generate(prompts, 2)


# --------------------------------------------------------------------------- #
# decoder plans of the new archs                                               #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", ["granite-3-2b", "phi4-narrow"])
def test_decoder_plans_match_jax_plans(case):
    c = lm_case(case)
    jcfg, cfg = c["jcfg"], c["cfg"]
    b, s, span = 2, 9, 12
    phases = ("prefill", "decode")
    jgraphs = {ph: joptimize(jbuild(c["jparams"], jcfg, phase=ph)) for ph in phases}
    graphs = {ph: optimize(build_decoder_graph(c["params"], cfg, phase=ph)) for ph in phases}
    assert [n.name for n in graphs["prefill"].nodes] == [n.name for n in jgraphs["prefill"].nodes]
    rng = np.random.default_rng(8)
    tok = _tokens(cfg, b, s)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    lens = np.array([s, 5], np.int32)
    kv = (b, cfg.n_layers, span, cfg.n_kv_heads, cfg.resolved_head_dim)
    k_ctx = rng.standard_normal(kv).astype(np.float32)
    v_ctx = rng.standard_normal(kv).astype(np.float32)
    dlens = np.array([7, 3], np.int32)
    inputs = {"prefill": (tok, pos, lens),
              "decode": (tok[:, :1], dlens[:, None], k_ctx, v_ctx, dlens)}
    for ph in phases:
        jplan = jcompile_plan(jgraphs[ph], backend="reference")
        want = jplan(jgraphs[ph].params, *[jnp.asarray(a) for a in inputs[ph]])
        for backend in ("kernel", "reference"):
            plan = compile_plan(graphs[ph], backend=backend, device="cpu")
            got = plan(graphs[ph].params, *[torch.from_numpy(a) for a in inputs[ph]])
            assert len(got) == len(want) == 1 + 2 * cfg.n_layers
            for g, w in zip(got, want):
                _close(g, w)
    # the plain versions ran on the CPU: no kernel launched
    assert sum(tops.kernel_launch_counts().values()) == 0


# --------------------------------------------------------------------------- #
# the serve CLI's default path                                                 #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", NEW)
def test_serve_cli_default_path_on_cpu(arch, capsys):
    report = tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "8", "--new-tokens", "5", "--scheduler"])
    out = capsys.readouterr().out
    assert "generated (2, 5)" in out and "greedy parity ok" in out and "scheduler:" in out
    assert report["tokens"].shape == (2, 5) and report["parity"]["exact"]
    assert all(r.done for r in report["scheduler"])
    # the same draws as the JAX CLI: prompts from default_rng(seed)
    cfg = smoke_config(arch)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    model = get_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    want = Engine(model, params, batch_size=2, max_len=128).generate(torch.from_numpy(prompts), 5)
    np.testing.assert_array_equal(report["tokens"], want.tokens)


def test_serve_cli_default_path_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "granite-3-2b", "--smoke"])
