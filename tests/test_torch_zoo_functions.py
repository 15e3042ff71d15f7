"""The zoo's building blocks in the port against the JAX package, on the CPU,
at function level (f32, rtol = atol = 1e-4 unless stated):

* masks and ``sdpa``: ``_mask_bias`` (causal, window, prefix-LM) exactly,
  ``sdpa(impl="chunked")`` with a window and a prefix, and ``auto``'s rule;
* the sliding-window KV ring buffer: ``gqa_prefill`` past its wrap (ring
  layout) and ``gqa_decode_step`` wrapping again;
* MoE: ``_dispatch_indices`` exactly equal, an overflowing expert included
  (the kept token in the last slot is overwritten, as in JAX), top-k ties to
  the lower index, ``moe`` output and aux under overflow;
* MLA: the absorbed ``mla_decode_step`` against JAX, and at ``pos >=
  max_len`` (the write dropped, as JAX drops it);
* Mamba-2 at a prime and a chunk-multiple length, with its state, and the
  step recurrence against the chunked form;
* RG-LRU at S >= 33 (the doubling scan against ``associative_scan``), the
  scan against a sequential loop;
* layer norm, the causal conv1d and its decode step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jsmoke_config
from repro.models import attention as jattn
from repro.models import ffn as jffn
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import ffn as tffn
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from test_torch_zoo_models import close, numpy_tree, tree_map

TOL = dict(rtol=1e-4, atol=1e-4)

#: the JAX side jitted (one compile a shape instead of op-by-op dispatch)
_jprefill = jax.jit(jattn.gqa_prefill, static_argnums=(1, 4),
                    static_argnames=("window", "prefix_len"))
_jgqa_step = jax.jit(jattn.gqa_decode_step, static_argnums=1, static_argnames=("window",))
_jmla_prefill = jax.jit(jattn.mla_prefill, static_argnums=(1, 4))
_jmla_step = jax.jit(jattn.mla_decode_step, static_argnums=1)
_jmamba = jax.jit(jssm.mamba2_forward, static_argnums=1, static_argnames=("return_state",))
_jmamba_step = jax.jit(jssm.mamba2_step, static_argnums=1)
_jrglru = jax.jit(jrglru.rglru_block, static_argnums=1, static_argnames=("return_state",))
_jrglru_step = jax.jit(jrglru.rglru_step, static_argnums=1)
_jmoe = jax.jit(jffn.moe, static_argnums=1, static_argnames=("activation",))


def _params(jinit, jcfg, seed=0):
    """Both packages' params of one block, from a numpy seed in the JAX
    init's layout."""
    pnp = numpy_tree(jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg)), seed=seed)
    return tree_map(jnp.asarray, pnp), lm_params_from_numpy(pnp, device="cpu")


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------- #
# masks, sdpa                                                                  #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("causal,window,prefix", [(True, None, 0), (True, 5, 0), (True, None, 6),
                                                  (False, None, 0), (True, 4, 6), (False, 3, 0)])
def test_mask_bias_equals_jax(causal, window, prefix):
    q, kv = np.arange(3, 15, dtype=np.int32), np.arange(0, 17, dtype=np.int32)
    want = jattn._mask_bias(jnp.asarray(q), jnp.asarray(kv), causal=causal, window=window,
                            prefix_len=prefix)
    got = tattn._mask_bias(torch.from_numpy(q), torch.from_numpy(kv), causal=causal,
                           window=window, prefix_len=prefix)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window,prefix,causal", [(None, 0, True), (7, 0, True), (None, 9, True),
                                                  (None, 0, False)])
def test_chunked_sdpa_equals_jax_and_full(window, prefix, causal):
    """Online softmax over chunks of 8 keys (a ragged last chunk): the JAX
    package's ``_sdpa_chunked`` and the full form, GQA 4 heads on 2 groups,
    v narrower than q/k (MLA's shape)."""
    q, k, v = _x(2, 21, 4, 16), _x(2, 21, 2, 16, seed=2), _x(2, 21, 2, 8, seed=3)
    pos = np.arange(21, dtype=np.int32)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    want = jax.jit(lambda *a: jattn.sdpa(*a, impl="chunked", chunk=8, **kw))(
        *map(jnp.asarray, (q, k, v, pos, pos)))
    got = tattn.sdpa(*map(torch.from_numpy, (q, k, v, pos, pos)), impl="chunked", chunk=8, **kw)
    close(got, want)
    full = tattn.sdpa(*map(torch.from_numpy, (q, k, v, pos, pos)), impl="full", **kw)
    torch.testing.assert_close(got, full, **TOL)


def test_sdpa_auto_is_chunked_past_8192_keys():
    q, k = torch.zeros(1, 2, 1, 4), torch.zeros(1, 8193, 1, 4)
    calls = []
    real = tattn._sdpa_chunked
    try:
        tattn._sdpa_chunked = lambda *a, **kw: calls.append(a[0].shape[1]) or real(*a, **kw)
        pos_q, pos_k = torch.arange(2), torch.arange(8193)
        tattn.sdpa(q, k, k, pos_q, pos_k)  # Sq 2 > 1, Skv 8193 > 8192: chunked
        tattn.sdpa(q[:, :1], k, k, pos_q[:1], pos_k)  # one query: full
        tattn.sdpa(q, k[:, :8192], k[:, :8192], pos_q, pos_k[:8192])  # 8192 keys: full
    finally:
        tattn._sdpa_chunked = real
    assert calls == [2]


# --------------------------------------------------------------------------- #
# the sliding-window ring buffer                                               #
# --------------------------------------------------------------------------- #


def test_window_ring_buffer_past_its_wrap_equals_jax():
    """Window 8 over 13 prefill positions (ring layout: slot i holds the
    largest position < 13 congruent to i), then 11 decode steps wrapping the
    ring again: outputs and caches equal the JAX package's; a prefix of 3
    positions on top."""
    jcfg, cfg = jsmoke_config("qwen2.5-3b"), smoke_config("qwen2.5-3b")
    jp, tp = _params(jattn.init_gqa, jcfg)
    x = _x(2, 13, cfg.d_model)
    pos = np.broadcast_to(np.arange(13, dtype=np.int32), (2, 13))
    jy, jc = _jprefill(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), 32, window=8, prefix_len=3)
    y, c = tattn.gqa_prefill(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos.copy()), 32,
                             window=8, prefix_len=3)
    close(y, jy)
    assert tuple(c["k"].shape) == (2, 8, cfg.n_kv_heads, cfg.resolved_head_dim)
    for k in ("k", "v"):
        close(c[k], jc[k])
    assert c["pos"].tolist() == [13, 13]
    for t in range(11):
        xt = _x(2, 1, cfg.d_model, seed=10 + t)
        jy, jc = _jgqa_step(jp, jcfg, jnp.asarray(xt), jc, window=8)
        y, c = tattn.gqa_decode_step(tp, cfg, torch.from_numpy(xt), c, window=8)
        close(y, jy)
    for k in ("k", "v"):
        close(c[k], jc[k])
    assert c["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [24, 24]
    # an empty ring from init_kv_cache steps as JAX's does too
    jc = jattn.init_kv_cache(jcfg, 2, 32, window=4, dtype=jnp.float32)
    c = tattn.init_kv_cache(cfg, 2, 32, window=4, dtype=torch.float32)
    for t in range(6):
        xt = _x(2, 1, cfg.d_model, seed=30 + t)
        jy, jc = _jgqa_step(jp, jcfg, jnp.asarray(xt), jc, window=4)
        y, c = tattn.gqa_decode_step(tp, cfg, torch.from_numpy(xt), c, window=4)
        close(y, jy)


def test_decode_clamps_a_full_cache_to_its_last_slot():
    jcfg, cfg = jsmoke_config("qwen2.5-3b"), smoke_config("qwen2.5-3b")
    jp, tp = _params(jattn.init_gqa, jcfg)
    jc = jattn.init_kv_cache(jcfg, 1, 3, dtype=jnp.float32)
    c = tattn.init_kv_cache(cfg, 1, 3, dtype=torch.float32)
    for t in range(5):  # positions 3 and 4 overwrite slot 2
        xt = _x(1, 1, cfg.d_model, seed=40 + t)
        jy, jc = _jgqa_step(jp, jcfg, jnp.asarray(xt), jc)
        y, c = tattn.gqa_decode_step(tp, cfg, torch.from_numpy(xt), c)
        close(y, jy)
    close(c["k"], jc["k"])


# --------------------------------------------------------------------------- #
# MoE                                                                          #
# --------------------------------------------------------------------------- #


def _dispatch_both(expert_idx, n_experts, capacity):
    want = jffn._dispatch_indices(jnp.asarray(expert_idx), n_experts, capacity)
    got = tffn._dispatch_indices(torch.from_numpy(expert_idx), n_experts, capacity)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def test_dispatch_overflow_is_last_write_wins():
    """Six token-slots to expert 0 under capacity 4: slots 0-2 hold tokens
    0-2, and the clamped writes of tokens 3-5 land on slot 3 last-wins, so
    the kept token 3 is overwritten by the dropped token 5 (gather 0,
    invalid) -- exactly the JAX package's bookkeeping."""
    idx = np.array([[0, 0, 0, 0, 0, 0, 1, 2]], np.int32)
    got, want = _dispatch_both(idx, 3, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    gather, valid, kept = got
    assert gather[0, 0].tolist() == [0, 1, 2, 0] and valid[0, 0].tolist() == [1, 1, 1, 0]
    assert kept[0].tolist() == [1, 1, 1, 1, 0, 0, 1, 1]


@pytest.mark.parametrize("seed", range(4))
def test_dispatch_indices_equal_jax(seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 5, (3, 24)).astype(np.int32)
    got, want = _dispatch_both(idx, 5, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not got[2].all()  # some token-slots overflowed


def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.3], [0.25, 0.25, 0.25, 0.25, 0.0]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(probs), 3)
    gv, gi = tffn._top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert gi.tolist() == [[1, 2, 4], [0, 1, 2]]


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v2-236b"])
def test_moe_under_overflow_equals_jax(arch):
    """Router weights scaled up so two experts take most tokens: capacity
    overflows; output and aux equal the JAX package's."""
    jcfg, cfg = jsmoke_config(arch), smoke_config(arch)
    pnp = numpy_tree(jax.eval_shape(lambda: jffn.init_moe(jax.random.PRNGKey(0), jcfg)), seed=2)
    pnp["router"]["w"][:, :2] *= 8.0
    jp, tp = tree_map(jnp.asarray, pnp), lm_params_from_numpy(pnp, device="cpu")
    x = _x(2, 19, cfg.d_model)
    jy, jaux = _jmoe(jp, jcfg, jnp.asarray(x), activation=cfg.ffn_activation)
    y, aux = tffn.moe(tp, cfg, torch.from_numpy(x), activation=cfg.ffn_activation)
    close(y, jy)
    close(aux, jaux)
    logits = torch.from_numpy(x) @ tp["router"]["w"]
    _, top = tffn._top_k(torch.softmax(logits, -1), cfg.moe.top_k)
    loads = torch.bincount(top.reshape(-1), minlength=cfg.moe.n_routed)
    assert int(loads.max()) > max(int(19 * 2 / 8 * 1.25), 4)  # the capacity overflowed


# --------------------------------------------------------------------------- #
# MLA                                                                          #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v2-236b"])
def test_mla_prefill_and_absorbed_decode_equal_jax(arch):
    jcfg, cfg = jsmoke_config(arch), smoke_config(arch)
    jp, tp = _params(jattn.init_mla, jcfg)
    x = _x(2, 6, cfg.d_model)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    jy, jc = _jmla_prefill(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), 8)
    y, c = tattn.mla_prefill(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos), 8)
    close(y, jy)
    for k in ("c_kv", "k_rope"):
        close(c[k], jc[k])
    # two steps fill the cache, two more run at pos >= max_len (8, 9): the
    # write is dropped and every slot attended
    for t in range(4):
        xt = _x(2, 1, cfg.d_model, seed=20 + t)
        jy, jc = _jmla_step(jp, jcfg, jnp.asarray(xt), jc)
        y, c = tattn.mla_decode_step(tp, cfg, torch.from_numpy(xt), c)
        close(y, jy)
        for k in ("c_kv", "k_rope"):
            close(c[k], jc[k])
    assert c["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [10, 10]


def test_mla_decode_at_mixed_positions_past_max_len():
    """One row inside the cache, one past it: only the first row writes."""
    jcfg, cfg = jsmoke_config("deepseek-v2-lite-16b"), smoke_config("deepseek-v2-lite-16b")
    jp, tp = _params(jattn.init_mla, jcfg, seed=3)
    cache = {"c_kv": _x(2, 5, cfg.kv_lora_rank, seed=4), "k_rope": _x(2, 5, cfg.rope_head_dim,
                                                                       seed=5),
             "pos": np.array([2, 7], np.int32)}
    xt = _x(2, 1, cfg.d_model, seed=6)
    jy, jc = _jmla_step(jp, jcfg, jnp.asarray(xt), tree_map(jnp.asarray, cache))
    y, c = tattn.mla_decode_step(tp, cfg, torch.from_numpy(xt), tree_map(torch.from_numpy, cache))
    close(y, jy)
    for k in ("c_kv", "k_rope"):
        close(c[k], jc[k])
    np.testing.assert_array_equal(c["c_kv"][1].numpy(), cache["c_kv"][1])
    assert not np.array_equal(c["c_kv"][0, 2].numpy(), cache["c_kv"][0, 2])


def test_mla_decode_matches_its_full_form():
    """The absorbed step is the decompressed attention, one token at a
    time: prefill of 6 == prefill of 3 + 3 decode steps (last logits)."""
    cfg = smoke_config("deepseek-v2-236b")
    _, tp = _params(jattn.init_mla, jsmoke_config("deepseek-v2-236b"), seed=7)
    x = torch.from_numpy(_x(1, 6, cfg.d_model, seed=8))
    pos = torch.arange(6, dtype=torch.int32)[None]
    full, _ = tattn.mla_prefill(tp, cfg, x, pos, 8)
    _, c = tattn.mla_prefill(tp, cfg, x[:, :3], pos[:, :3], 8)
    outs = []
    for t in range(3, 6):
        y, c = tattn.mla_decode_step(tp, cfg, x[:, t:t + 1], c)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), full[:, 3:], **TOL)


# --------------------------------------------------------------------------- #
# Mamba-2                                                                      #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("s", [13, 32])
def test_mamba2_forward_and_state_equal_jax(s):
    """S = 13 (prime: chunks of 1, 13 recurrence steps) and S = 32 (two
    chunks of 16): the output and the returned state equal the JAX
    package's; 3 decode steps from that state too."""
    jcfg, cfg = jsmoke_config("mamba2-1.3b"), smoke_config("mamba2-1.3b")
    jp, tp = _params(jssm.init_mamba2, jcfg)
    x = _x(2, s, cfg.d_model)
    jy, jc = _jmamba(jp, jcfg, jnp.asarray(x), return_state=True)
    y, c = tssm.mamba2_forward(tp, cfg, torch.from_numpy(x), return_state=True)
    close(y, jy)
    for k in ("state", "conv"):
        close(c[k], jc[k])
    for t in range(3):
        xt = _x(2, 1, cfg.d_model, seed=50 + t)
        jy, jc = _jmamba_step(jp, jcfg, jnp.asarray(xt), jc)
        y, c = tssm.mamba2_step(tp, cfg, torch.from_numpy(xt), c)
        close(y, jy)
    close(c["state"], jc["state"])


def test_mamba2_chunked_form_equals_the_recurrence():
    cfg = smoke_config("mamba2-1.3b")
    _, tp = _params(jssm.init_mamba2, jsmoke_config("mamba2-1.3b"), seed=3)
    x = torch.from_numpy(_x(1, 20, cfg.d_model, seed=4))
    y, c = tssm.mamba2_forward(tp, cfg, x, return_state=True)
    cache = tssm.init_mamba2_cache(cfg, 1, torch.float32)
    steps = []
    for t in range(20):
        yt, cache = tssm.mamba2_step(tp, cfg, x[:, t:t + 1], cache)
        steps.append(yt)
    torch.testing.assert_close(torch.cat(steps, 1), y, **TOL)
    torch.testing.assert_close(cache["state"], c["state"], **TOL)


# --------------------------------------------------------------------------- #
# RG-LRU                                                                       #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("s", [33, 40])
def test_rglru_block_and_state_equal_jax(s):
    jcfg, cfg = jsmoke_config("recurrentgemma-9b"), smoke_config("recurrentgemma-9b")
    jp, tp = _params(jrglru.init_rglru_block, jcfg)
    x = _x(2, s, cfg.d_model)
    jy, jc = _jrglru(jp, jcfg, jnp.asarray(x), return_state=True)
    y, c = trglru.rglru_block(tp, cfg, torch.from_numpy(x), return_state=True)
    close(y, jy)
    for k in ("h", "conv"):
        close(c[k], jc[k])
    for t in range(3):
        xt = _x(2, 1, cfg.d_model, seed=60 + t)
        jy, jc = _jrglru_step(jp, jcfg, jnp.asarray(xt), jc)
        y, c = trglru.rglru_step(tp, cfg, torch.from_numpy(xt), c)
        close(y, jy)
    close(c["h"], jc["h"])


@pytest.mark.parametrize("s", [1, 2, 7, 33, 64])
def test_linear_scan_equals_the_loop(s):
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (3, s, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, s, 5)).astype(np.float32))
    h, want = torch.zeros(3, 5), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(trglru.linear_scan(a, b, dim=1), torch.stack(want, 1), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------- #
# layers                                                                       #
# --------------------------------------------------------------------------- #


def test_layernorm_and_conv1d_equal_jax():
    rng = np.random.default_rng(0)
    p = {"scale": rng.uniform(0.5, 1.5, 24).astype(np.float32),
         "bias": (rng.standard_normal(24) * 0.1).astype(np.float32)}
    x = (_x(2, 5, 24) * 3 + 1).astype(np.float32)
    close(tlayers.layernorm(tree_map(torch.from_numpy, p), torch.from_numpy(x), 1e-6),
          jlayers.layernorm(tree_map(jnp.asarray, p), jnp.asarray(x), 1e-6))
    cp = {"w": _x(4, 24, seed=2), "b": (_x(24, seed=3) * 0.1).astype(np.float32)}
    jc, tc = tree_map(jnp.asarray, cp), tree_map(torch.from_numpy, cp)
    close(tlayers.causal_conv1d(tc, torch.from_numpy(x)), jlayers.causal_conv1d(jc, jnp.asarray(x)))
    win = _x(2, 3, 24, seed=4)
    jy, jw = jlayers.conv1d_step(jc, jnp.asarray(win), jnp.asarray(x[:, 0]))
    y, w = tlayers.conv1d_step(tc, torch.from_numpy(win), torch.from_numpy(x[:, 0]))
    close(y, jy)
    close(w, jw)
    # the step over a zero window is the full conv's first position
    y0, _ = tlayers.conv1d_step(tc, torch.zeros(2, 3, 24), torch.from_numpy(x[:, 0]))
    torch.testing.assert_close(y0, tlayers.causal_conv1d(tc, torch.from_numpy(x))[:, 0])


def test_linear_promotes_mixed_types_as_jnp():
    w = {"w": torch.ones(3, 2, dtype=torch.bfloat16)}
    y = tlayers.linear(w, torch.full((1, 3), 0.5))
    assert y.dtype == torch.float32 and y.tolist() == [[1.5, 1.5]]
    jy = jlayers.linear({"w": jnp.ones((3, 2), jnp.bfloat16)}, jnp.full((1, 3), 0.5, jnp.float32))
    assert str(jy.dtype) == "float32"


def test_window_layers_never_run_in_recurrentgemma():
    """The hybrid's pattern names ``attn``, never ``localattn``: its
    attention layers get no window (ROADMAP C), in both packages."""
    from repro.models.transformer import block_kinds as jkinds
    from repro_torch.models.transformer import block_kinds

    for cfg in (smoke_config("recurrentgemma-9b"),
                dataclasses.replace(smoke_config("recurrentgemma-9b"), n_layers=38)):
        assert block_kinds(cfg) == jkinds(cfg)
        assert "localattn" not in block_kinds(cfg)
