"""The rest of the model zoo in the port against the JAX package, on the CPU,
per arch at its f32 smoke config: qwen3-14b (qk_norm), deepseek-v2-lite-16b
and deepseek-v2-236b (MLA + MoE; 236b's smoke config is the only path with
``q_lora_rank``), paligemma-3b (prefix-LM over 16 patch embeddings, MQA,
tied embeddings, GeGLU), mamba2-1.3b (chunked SSD), recurrentgemma-9b
(RG-LRU + attention) and whisper-small (encoder-decoder).

Both packages get the same params: ``numpy_tree`` fills the JAX package's
own ``init_lm`` / ``init_encdec`` layout (its shapes and dtypes from
``jax.eval_shape``) from a numpy seed, and ``lm_params_from_numpy`` carries
it into the port.  What is held, at rtol = atol = 1e-4:

* ``forward`` logits and the MoE aux loss, and ``loss``;
* prefill logits and every layer's cache, then 4 decode steps' logits and
  caches;
* ``Engine.generate`` greedy tokens and a 2-slot ``RequestScheduler`` run
  over 4 requests: exactly the JAX package's;
* whisper: ``encode``, ``decode_train``, ``loss``, ``precompute_cross_kv``
  and 4 ``decode_step``s through ``get_model`` with ``(self_caches,
  cross_kv)``; ``Engine`` refuses it, as the JAX engine does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jsmoke_config
from repro.models import encdec as jencdec
from repro.models import get_model as jget_model
from repro.models import transformer as jlm
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import RequestScheduler as JRequestScheduler
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import encdec as tencdec
from repro_torch.models import get_model
from repro_torch.models import transformer as tlm
from repro_torch.serving import Engine, Request, RequestScheduler

#: the JAX side jitted (one compile a shape instead of op-by-op dispatch)
_jforward = jax.jit(jlm.forward, static_argnums=1)
_jprefill = jax.jit(jlm.prefill, static_argnums=(1, 3))
_jencode = jax.jit(jencdec.encode, static_argnums=1)
_jdecode_train = jax.jit(jencdec.decode_train, static_argnums=1)

ZOO = ("qwen3-14b", "deepseek-v2-lite-16b", "deepseek-v2-236b", "paligemma-3b",
       "mamba2-1.3b", "recurrentgemma-9b")
TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 48


def numpy_tree(shapes, seed=0):
    """A param tree of numpy arrays in the layout of ``shapes`` (a tree of
    ``jax.ShapeDtypeStruct``): weights ~ N(0, 1/fan_in), norm scales in
    [0.5, 1.5], small biases, the SSM / RG-LRU leaves in their init's
    ranges."""
    rng = np.random.default_rng(seed)

    def leaf(key, sd):
        shape, dt = tuple(sd.shape), np.dtype(sd.dtype)
        if key == "scale" or key == "D":
            a = rng.uniform(0.5, 1.5, shape)
        elif key in ("bias", "b", "dt_bias"):
            a = rng.standard_normal(shape) * 0.1
        elif key == "A_log":
            a = np.log(rng.uniform(1.0, 16.0, shape))
        elif key == "lam":
            a = rng.uniform(3.0, 8.0, shape)
        elif key in ("table", "enc_pos"):
            a = rng.standard_normal(shape) * 0.5
        else:  # w [d_in, d_out], conv w [width, C], expert stacks [E, d_in, d_out]
            a = rng.standard_normal(shape) / np.sqrt(shape[-2])
        return a.astype(dt)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, key) for v in node)
        return leaf(key, node)

    return walk(shapes)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


_CASES = {}


def zoo_case(arch):
    """Both packages' smoke config, model and params for ``arch`` (built
    once per test process)."""
    if arch not in _CASES:
        jcfg, cfg = jsmoke_config(arch), smoke_config(arch)
        init = jencdec.init_encdec if cfg.is_encdec else jlm.init_lm
        pnp = numpy_tree(jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jcfg)),
                         seed=len(arch))
        jmodel = jget_model(jcfg)
        _CASES[arch] = dict(jcfg=jcfg, cfg=cfg, pnp=pnp, jparams=tree_map(jnp.asarray, pnp),
                            params=lm_params_from_numpy(pnp, device="cpu"),
                            jmodel=jmodel, model=get_model(cfg, device="cpu"),
                            jloss=jax.jit(jmodel.loss), jfwd=jax.jit(jmodel.forward),
                            jstep=jax.jit(jmodel.decode_step))
    return _CASES[arch]


def tokens(cfg, b, s, seed=4):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def patches(cfg, b, seed=9):
    if not cfg.vision_tokens:
        return None
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def close_caches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            assert tuple(g[k].shape) == tuple(w[k].shape), k
            if k == "pos":
                assert g[k].tolist() == np.asarray(w[k]).tolist()
            else:
                close(g[k], w[k])


# --------------------------------------------------------------------------- #
# decoder-only families                                                        #
# --------------------------------------------------------------------------- #


def test_param_trees_are_the_jax_layout():
    """The port's own ``init`` builds the JAX package's tree (shapes and
    dtypes) for every zoo arch, whisper included."""
    for arch in ZOO + ("whisper-small",):
        c = zoo_case(arch)
        got = c["model"].init(torch.Generator().manual_seed(0))
        want = tree_map(lambda a: (a.shape, str(a.dtype)), c["pnp"])
        assert tree_map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), got) == want


@pytest.mark.parametrize("arch", ZOO)
def test_forward_aux_and_loss_match_jax(arch):
    c = zoo_case(arch)
    jcfg, cfg = c["jcfg"], c["cfg"]
    tok, pe = tokens(cfg, 2, 11), patches(cfg, 2)
    jlogits, jaux = _jforward(c["jparams"], jcfg, jnp.asarray(tok), patch_embeds=_j(pe))
    logits, aux = tlm.forward(c["params"], cfg, torch.from_numpy(tok), patch_embeds=_t(pe))
    assert tuple(logits.shape) == (2, 11, cfg.vocab_padded)
    close(logits, jlogits)
    close(aux, jaux)
    assert (float(aux) > 0) == (cfg.moe is not None)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if pe is not None:
        batch["patch_embeds"] = pe
    jl, jm = c["jloss"](c["jparams"], tree_map(jnp.asarray, batch))
    loss, m = c["model"].loss(c["params"], tree_map(torch.from_numpy, batch))
    close(loss, jl)
    close(m["ce"], jm["ce"])
    close(m["aux"], jm["aux"])
    close(c["model"].forward(c["params"], tree_map(torch.from_numpy, batch)),
          c["jfwd"](c["jparams"], tree_map(jnp.asarray, batch)))


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_caches_and_decode_steps_match_jax(arch):
    c = zoo_case(arch)
    jcfg, cfg = c["jcfg"], c["cfg"]
    tok, pe = tokens(cfg, 2, 7), patches(cfg, 2)
    jlogits, jcaches = _jprefill(c["jparams"], jcfg, jnp.asarray(tok), MAX_LEN,
                                 patch_embeds=_j(pe))
    logits, caches = tlm.prefill(c["params"], cfg, torch.from_numpy(tok), MAX_LEN,
                                 patch_embeds=_t(pe))
    close(logits, jlogits)
    close_caches(caches, jcaches)
    nxt = tokens(cfg, 2, 4, seed=5)
    for t in range(nxt.shape[1]):
        step = nxt[:, t:t + 1]
        jlogits, jcaches = c["jstep"](c["jparams"], {"tokens_t": jnp.asarray(step)}, jcaches)
        logits, caches = c["model"].decode_step(c["params"], {"tokens_t": torch.from_numpy(step)},
                                                caches)
        assert tuple(logits.shape) == (2, 1, cfg.vocab_padded)
        close(logits, jlogits)
    close_caches(caches, jcaches)
    # and from empty caches: init_cache is the JAX package's
    want = c["jmodel"].init_cache(2, MAX_LEN)
    got = c["model"].init_cache(2, MAX_LEN)
    assert tree_map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), got) == \
        tree_map(lambda a: (tuple(a.shape), str(a.dtype)), want)


@pytest.mark.parametrize("arch", ZOO)
def test_engine_and_scheduler_tokens_equal_jax(arch):
    """``Engine.generate`` (a VLM with its patch embeddings) and a 2-slot
    ``RequestScheduler`` over 4 requests of two prompt lengths: exactly the
    JAX package's tokens and returned list."""
    c = zoo_case(arch)
    prompts, pe = tokens(c["cfg"], 2, 6, seed=6), patches(c["cfg"], 2)
    jeng = JEngine(c["jmodel"], c["jparams"], batch_size=2, max_len=MAX_LEN)
    eng = Engine(c["model"], c["params"], batch_size=2, max_len=MAX_LEN)
    want = jeng.generate(jnp.asarray(prompts), 5, patch_embeds=_j(pe))
    got = eng.generate(torch.from_numpy(prompts), 5, patch_embeds=_t(pe))
    assert got.tokens.shape == (2, 5)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))

    rng = np.random.default_rng(7)
    spec = [(rid, rng.integers(0, c["cfg"].vocab, (5, 8)[rid % 2]).astype(np.int32),
             int(rng.integers(3, 6))) for rid in range(4)]
    jsched, sched = JRequestScheduler(jeng), RequestScheduler(eng)
    jreqs = [JRequest(rid=r, prompt=p, max_new=n) for r, p, n in spec]
    reqs = [Request(rid=r, prompt=p, max_new=n) for r, p, n in spec]
    for jr, r in zip(jreqs, reqs):
        jsched.submit(jr)
        sched.submit(r)
    jdone, done = jsched.run(), sched.run()
    assert [r.rid for r in done] == [r.rid for r in jdone]
    assert [(r.generated, r.done) for r in reqs] == [(r.generated, r.done) for r in jreqs]
    assert all(len(r.generated) == r.max_new for r in reqs)


# --------------------------------------------------------------------------- #
# encoder-decoder                                                              #
# --------------------------------------------------------------------------- #


def test_whisper_encode_decode_and_steps_match_jax():
    c = zoo_case("whisper-small")
    jcfg, cfg = c["jcfg"], c["cfg"]
    frames = np.random.default_rng(8).standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    tok = tokens(cfg, 2, 9)
    jenc = _jencode(c["jparams"], jcfg, jnp.asarray(frames))
    enc = tencdec.encode(c["params"], cfg, torch.from_numpy(frames))
    close(enc, jenc)
    jlogits = _jdecode_train(c["jparams"], jcfg, jnp.asarray(tok), jenc)
    logits = tencdec.decode_train(c["params"], cfg, torch.from_numpy(tok), enc)
    close(logits, jlogits)
    batch = {"frames": frames, "tokens": tok[:, :-1], "labels": tok[:, 1:]}
    jl, _ = c["jloss"](c["jparams"], tree_map(jnp.asarray, batch))
    loss, m = c["model"].loss(c["params"], tree_map(torch.from_numpy, batch))
    close(loss, jl)
    assert m["ce"] is loss
    close(c["model"].forward(c["params"], tree_map(torch.from_numpy, batch)),
          c["jfwd"](c["jparams"], tree_map(jnp.asarray, batch)))

    jcross = jencdec.precompute_cross_kv(c["jparams"], jcfg, jenc)
    cross = tencdec.precompute_cross_kv(c["params"], cfg, enc)
    for (k, v), (jk, jv) in zip(cross, jcross):
        close(k, jk)
        close(v, jv)
    jstate = (c["jmodel"].init_cache(2, MAX_LEN), jcross)
    state = (c["model"].init_cache(2, MAX_LEN), cross)
    step_logits = []
    for t in range(4):
        step = tok[:, t:t + 1]
        jl, jstate = c["jstep"](c["jparams"], {"tokens_t": jnp.asarray(step)}, jstate)
        lg, state = c["model"].decode_step(c["params"], {"tokens_t": torch.from_numpy(step)},
                                           state)
        close(lg, jl)
        step_logits.append(lg[:, 0])
    close_caches(state[0], jstate[0])
    assert state[1] is cross
    # the decode steps are the teacher-forced pass, one token at a time
    torch.testing.assert_close(torch.stack(step_logits, 1), logits[:, :4], **TOL)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        Engine(c["model"], c["params"], batch_size=2, max_len=MAX_LEN)
