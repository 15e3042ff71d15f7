"""The MoE and Mamba-2 paths in bf16 in the port against the JAX package, on
the CPU: the smoke configs of deepseek-v2-lite-16b, deepseek-v2-236b (MLA
with ``q_lora_rank``) and mamba2-1.3b with ``dtype="bfloat16"``, params a
numpy tree in the JAX package's bf16 layout (``numpy_tree``).

bf16 parity rests on rounding at the JAX package's cast points.  Each block
and mixer is fed the JAX package's own input, so a rounding the two
packages place differently shows at once; the tolerance is that of one
rounding placed differently at each of a block's two residual adds,
``BLOCK_ULPS`` bf16 ulps of the output's largest magnitude.  Held so:

* ``forward``: every block's output and MoE aux loss, layer by layer;
* prefill: every layer's mixer (``mla_prefill`` / ``mamba2_forward`` with
  its state) and its cache; then 4 one-token steps (``mla_decode_step`` /
  ``mamba2_step``) from the JAX package's caches, and the MoE FFN at S = 1;
* mamba2 end to end: ``forward``, prefill and 4 decode steps bit-equal to
  the JAX package compiled with XLA rounding at every cast point (``strict``:
  by default XLA may keep a fused bf16 intermediate in f32).  A MoE model
  is held block by block only: its bf16 GEMMs sum in another order than
  XLA's (1-ulp differences), these move the next layer's router input,
  and a top-k near-tie (a prob gap of 7e-4 in deepseek-v2-lite's smoke
  model) can then pick another expert, a discrete change that no
  tolerance on the logits describes;
* the chunked SSD against the step recurrence: the port's bf16 gap between
  ``forward`` and prefill-then-steps is the strict JAX package's (in f32
  both agree to ~1e-6).
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
from repro.models import ssm as jssm
from repro.models import transformer as jlm
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.ref import bf16_ulp
from repro_torch.models import attention as tattn
from repro_torch.models import ffn as tffn
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tlm
from test_torch_zoo_models import numpy_tree, tokens, tree_map

ARCHS = ("deepseek-v2-lite-16b", "deepseek-v2-236b", "mamba2-1.3b")
#: one bf16 rounding placed differently at each residual add of a block
BLOCK_ULPS = 2
MAX_LEN = 16

_CASES = {}


def strict(fn, static=()):
    """``fn`` jitted with XLA rounding every bf16 cast where the JAX code puts
    it (``xla_allow_excess_precision`` off: by default XLA may keep a fused
    intermediate in f32 across a cast, which no eager op does)."""
    return jax.jit(fn, static_argnums=static,
                   compiler_options={"xla_allow_excess_precision": False})


_jblock = strict(jlm._apply_block, (1, 2, 3))
_jmamba2_forward = strict(lambda p, cfg, x: jssm.mamba2_forward(p, cfg, x, return_state=True),
                          (1,))
_jmamba2_step = strict(jssm.mamba2_step, (1,))
_jmla_prefill = strict(jattn.mla_prefill, (1, 4))
_jmla_decode_step = strict(jattn.mla_decode_step, (1,))
_jmoe = strict(jffn.moe, (1,))


def bf16_case(arch):
    if arch not in _CASES:
        jcfg = dataclasses.replace(jsmoke_config(arch), dtype="bfloat16")
        cfg = dataclasses.replace(smoke_config(arch), dtype="bfloat16")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        pnp = numpy_tree(jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), jcfg)),
                         seed=len(arch))
        _CASES[arch] = dict(jcfg=jcfg, cfg=cfg, jparams=tree_map(jnp.asarray, pnp),
                            params=lm_params_from_numpy(pnp, device="cpu"))
    return _CASES[arch]


def _t(a):
    """A JAX array as a torch tensor of its dtype (bf16 through f32, exactly)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def within_ulps(got, want, ulps, what):
    """``got`` within ``ulps`` bf16 ulps of ``max |want|``; the same dtype."""
    g, w = _f32(got), _f32(want)
    assert str(got.dtype).split(".")[-1] == str(jnp.asarray(want).dtype), what
    tol = ulps * bf16_ulp(float(np.abs(w).max()))
    err = float(np.abs(g - w).max())
    assert err <= tol, f"{what}: max |port - jax| {err} > {tol} ({ulps} bf16 ulps)"


def close_cache(got, want, what):
    for k in want:
        if k == "pos":
            assert got[k].tolist() == np.asarray(want[k]).tolist(), what
        elif want[k].dtype == jnp.float32:  # the SSM state: f32 sums of bf16 inputs
            np.testing.assert_allclose(_f32(got[k]), _f32(want[k]), rtol=1e-4, atol=1e-4,
                                       err_msg=f"{what}: {k}")
        else:
            within_ulps(got[k], want[k], 1, f"{what}: {k}")


def _layer_inputs(c, tok):
    """The JAX package's ``forward``, layer by layer: each layer's input,
    output and aux."""
    jcfg, jp = c["jcfg"], c["jparams"]
    x = jlayers.embed(jp["embed"], jnp.asarray(tok))
    pos = jnp.broadcast_to(jnp.arange(tok.shape[1], dtype=jnp.int32), tok.shape)
    out = []
    for i, (lp, kind) in enumerate(zip(jp["layers"], jlm.block_kinds(jcfg))):
        y, aux = _jblock(lp, jcfg, kind, i, x, pos)
        out.append((x, y, aux))
        x = y
    return pos, out


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_blocks_match_jax(arch):
    c = bf16_case(arch)
    cfg = c["cfg"]
    pos, layers = _layer_inputs(c, tokens(cfg, 2, 11))
    for i, (lp, kind, (x, y, aux)) in enumerate(zip(c["params"]["layers"],
                                                   tlm.block_kinds(cfg), layers)):
        got, got_aux = tlm._apply_block(lp, cfg, kind, _t(x), _t(pos))
        within_ulps(got, y, BLOCK_ULPS, f"{arch} layer {i} ({kind})")
        if "moe" in lp:  # the router reads the block's own bf16 residual: one ulp
            np.testing.assert_allclose(float(got_aux), float(aux), rtol=2.0 ** -8)
        else:
            assert got_aux is None and float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_mixers_match_jax(arch):
    """Every layer's prefill mixer and cache, then 4 one-token steps from the
    JAX package's caches (each step's input the same seeded bf16 row),
    and the MoE FFN over one token a row as a decode step runs it."""
    c = bf16_case(arch)
    jcfg, cfg = c["jcfg"], c["cfg"]
    pos, layers = _layer_inputs(c, tokens(cfg, 2, 7))
    rng = np.random.default_rng(11)
    steps = [jnp.asarray(rng.standard_normal((2, 1, cfg.d_model)), jnp.bfloat16)
             for _ in range(4)]
    for i, (jl, tl, (x, _, _)) in enumerate(zip(c["jparams"]["layers"], c["params"]["layers"],
                                               layers)):
        h = jlayers.rmsnorm(jl["norm1"], x, jcfg.norm_eps)
        what = f"{arch} layer {i}"
        if "mixer" in jl:
            jy, jcache = _jmamba2_forward(jl["mixer"], jcfg, h)
            y, cache = tssm.mamba2_forward(tl["mixer"], cfg, _t(h), return_state=True)
            jstep, tstep = _jmamba2_step, tssm.mamba2_step
            part = "mixer"
        else:
            jy, jcache = _jmla_prefill(jl["attn"], jcfg, h, pos, MAX_LEN)
            y, cache = tattn.mla_prefill(tl["attn"], cfg, _t(h), _t(pos), MAX_LEN)
            jstep, tstep = _jmla_decode_step, tattn.mla_decode_step
            part = "attn"
        within_ulps(y, jy, BLOCK_ULPS, f"{what} prefill")
        close_cache(cache, jcache, f"{what} prefill cache")
        for t, x_t in enumerate(steps):
            y, cache = tstep(tl[part], cfg, _t(x_t), tree_map(_t, jcache))
            jy, jcache = jstep(jl[part], jcfg, x_t, jcache)
            within_ulps(y, jy, BLOCK_ULPS, f"{what} step {t}")
            close_cache(cache, jcache, f"{what} step {t} cache")
        if "moe" in jl:
            jy, jaux = _jmoe(jl["moe"], jcfg, steps[0])
            y, aux = tffn.moe(tl["moe"], cfg, _t(steps[0]))
            within_ulps(y, jy, BLOCK_ULPS, f"{what} moe at S = 1")
            np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)  # same input


def test_bf16_mamba2_end_to_end_equals_strict_jax():
    """With XLA rounding at every cast point, the port's bf16 mamba2 is the
    JAX package's bit for bit: ``forward``, prefill, 4 decode steps' logits
    and the conv windows (the f32 SSD state within f32 rounding)."""
    c = bf16_case("mamba2-1.3b")
    jcfg, cfg, jp = c["jcfg"], c["cfg"], c["jparams"]
    tok = tokens(cfg, 2, 11)

    def equal(got, want, what):
        assert np.array_equal(_f32(got), _f32(want)), f"{what}: not bit-equal"

    jtok = jnp.asarray(tok)
    jl, _ = strict(jlm.forward, (1,))(jp, jcfg, jtok)
    equal(tlm.forward(c["params"], cfg, torch.from_numpy(tok))[0], jl, "forward")
    jl, jcaches = strict(jlm.prefill, (1, 3))(jp, jcfg, jtok[:, :7], MAX_LEN)
    logits, caches = tlm.prefill(c["params"], cfg, torch.from_numpy(tok[:, :7]), MAX_LEN)
    equal(logits, jl, "prefill")
    jstep = strict(jlm.decode_step, (1,))
    for t in range(7, 11):
        step = tok[:, t:t + 1]
        jl, jcaches = jstep(jp, jcfg, jnp.asarray(step), jcaches)
        logits, caches = tlm.decode_step(c["params"], cfg, torch.from_numpy(step), caches)
        equal(logits, jl, f"decode step {t}")
    for got, want in zip(caches, jcaches):
        equal(got["conv"], want["conv"], "conv window")
        # the f32 state: the same f32 products, summed in another order
        np.testing.assert_allclose(_f32(got["state"]), _f32(want["state"]), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mamba2_chunked_forward_vs_step_recurrence(dtype):
    """``forward`` (chunked SSD) against prefill of one token and one step a
    token after it (the recurrence), in both packages: in f32 both agree
    to ~1e-6; in bf16 the port's gap is the strict JAX package's, bit for
    bit (``tools/mamba2_bf16_gap.py`` measures both at full width)."""
    c = bf16_case("mamba2-1.3b")
    jcfg = dataclasses.replace(c["jcfg"], dtype=dtype)
    cfg = dataclasses.replace(c["cfg"], dtype=dtype)
    jp = tree_map(lambda a: a.astype(dtype) if a.dtype == jnp.bfloat16 else a, c["jparams"])
    tp = tree_map(lambda t: t.to(getattr(torch, dtype)) if t.dtype == torch.bfloat16 else t,
                  c["params"])
    tok = tokens(cfg, 2, 12)
    jfwd, jpre, jstep = (strict(jlm.forward, (1,)), strict(jlm.prefill, (1, 3)),
                         strict(jlm.decode_step, (1,)))
    jgap = _chunked_vs_steps(lambda t: jfwd(jp, jcfg, jnp.asarray(t))[0],
                             lambda t: jpre(jp, jcfg, jnp.asarray(t), 16),
                             lambda t, cs: jstep(jp, jcfg, jnp.asarray(t), cs), tok, cfg.vocab)
    tgap = _chunked_vs_steps(lambda t: tlm.forward(tp, cfg, torch.from_numpy(t))[0],
                             lambda t: tlm.prefill(tp, cfg, torch.from_numpy(t), 16),
                             lambda t, cs: tlm.decode_step(tp, cfg, torch.from_numpy(t), cs),
                             tok, cfg.vocab)
    if dtype == "float32":
        assert jgap < 1e-4 and tgap < 1e-4, (jgap, tgap)
    else:
        assert tgap == jgap, (tgap, jgap)


def _chunked_vs_steps(forward, prefill, decode_step, tok, v):
    """max |forward logits - (prefill of the first token, then one step a
    token)| over the sequence and the real classes."""
    full = _f32(forward(tok))[..., :v]
    first, caches = prefill(tok[:, :1])
    rows = [_f32(first)[..., :v]]
    for t in range(1, tok.shape[1]):
        logits, caches = decode_step(tok[:, t:t + 1], caches)
        rows.append(_f32(logits)[..., :v])
    return float(np.abs(np.concatenate(rows, 1) - full).max())
