"""The memory knobs of ``forward`` / ``loss_fn`` and the model accounting of
``utils/flops`` against the JAX package, on the CPU.

* ``remat`` ("full" and "dots"), ``layout_scan`` (alone and with remat) and
  ``attn_chunk`` on qwen2.5-3b, deepseek-v2-lite-16b and recurrentgemma-9b
  at their f32 smoke configs (the archs of the JAX package's own
  ``test_scan_layout_equals_unrolled``), and ``remat`` / ``layout_scan`` on
  whisper's ``encode`` / ``decode_train`` / ``loss_fn``: the loss within
  rtol 1e-5 and every gradient leaf within 1e-5 x max(1, max|g|) of
  ``jax.value_and_grad`` of the JAX ``loss_fn`` with the same knobs (the
  same f32 ops summed in another order; recurrentgemma's doubling scan
  against ``associative_scan`` is the widest, ~4e-6), ``forward`` logits
  and whisper's encoder output within 1e-5 x max(1, max|jax|).  In eager
  PyTorch remat recomputes the same ops and the "scan" runs the unrolled
  loop, so those gradients are ``torch.equal`` to the port's default; and
  remat does recompute in the backward ("full" its 2-D matmuls too, "dots"
  all but them).
* A ``residual_spec`` (a TPU sharding constraint) still raises, naming A9.
* ``scan_plan`` and ``shape_cells`` equal the JAX package's for all ten
  archs, and ``param_counts`` / ``model_flops`` on all ten full configs, the
  port's tree of meta tensors (``flops.meta_params``) against
  ``jax.eval_shape`` of the JAX init (the same leaf paths, shapes and
  dtypes).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as jregistry
from repro.configs.base import SHAPES as JSHAPES
from repro.models import encdec as jencdec
from repro.models import transformer as jlm
from repro.utils import flops as jflops
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_cells, smoke_config
from repro_torch.models import encdec as tencdec
from repro_torch.models.sharding import P
from repro_torch.models import transformer as tlm
from repro_torch.utils import flops
from repro_torch.utils.tree import leaves, leaves_with_path
from test_torch_zoo_models import zoo_case

KNOBS = {
    "remat_full": dict(remat=True),
    "remat_dots": dict(remat=True, remat_policy="dots"),
    "layout_scan": dict(layout_scan=True),
    "scan_remat_dots": dict(layout_scan=True, remat=True, remat_policy="dots"),
    "attn_chunk": dict(attn_impl="chunked", attn_chunk=8),
}
ARCHS = ("qwen2.5-3b", "deepseek-v2-lite-16b", "recurrentgemma-9b")
RTOL = 1e-5


def _batch(cfg, b=2, s=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encdec:
        out["frames"] = np.random.default_rng(seed + 1).standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _port_grads(loss_fn, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)`` by autograd."""
    ws = leaves(params)
    for w in ws:
        w.requires_grad_(True)
    try:
        loss, _ = loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, ws)
    finally:
        for w in ws:
            w.requires_grad_(False)
    return loss.detach(), grads


def _jax_grads(loss_fn, jparams, batch):
    f = jax.jit(jax.value_and_grad(lambda p, b: loss_fn(p, b)[0]))
    return f(jparams, {k: jnp.asarray(v) for k, v in batch.items()})


def _assert_grads_close(grads, jgrads, params):
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    paths = [p for p, _ in leaves_with_path(params)]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == paths
    for path, got, (_, want) in zip(paths, grads, jflat):
        want = np.asarray(want, np.float32)
        tol = RTOL * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol, err_msg=path)


def _close(got, want):
    """Within RTOL x max(1, max|want|)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL * max(1.0, float(np.abs(want).max())))


_DEFAULT = {}


def _default_grads(arch):
    """The port's loss and gradients with every knob at its default."""
    if arch not in _DEFAULT:
        c = zoo_case(arch)
        _DEFAULT[arch] = _port_grads(lambda p, b: tlm.loss_fn(p, c["cfg"], b), c["params"],
                                     _batch(c["cfg"]))
    return _DEFAULT[arch]


@pytest.mark.parametrize("knob", KNOBS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_with_knobs_match_jax(arch, knob):
    c, kw = zoo_case(arch), KNOBS[knob]
    b = _batch(c["cfg"])
    jl, jg = _jax_grads(lambda p, bb: jlm.loss_fn(p, c["jcfg"], bb, **kw), c["jparams"], b)
    loss, grads = _port_grads(lambda p, bb: tlm.loss_fn(p, c["cfg"], bb, **kw), c["params"], b)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
    _assert_grads_close(grads, jg, c["params"])
    if knob != "attn_chunk":  # remat / scan: the default's computation, bit for bit
        dl, dg = _default_grads(arch)
        assert loss.item() == dl.item()
        assert all(torch.equal(a, d) for a, d in zip(grads, dg))


@pytest.mark.parametrize("knob", ["layout_scan", "attn_chunk"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_knobs_matches_jax(arch, knob):
    c, kw = zoo_case(arch), KNOBS[knob]
    toks = _batch(c["cfg"])["tokens"]
    want, jaux = jax.jit(lambda p, t: jlm.forward(p, c["jcfg"], t, **kw))(
        c["jparams"], jnp.asarray(toks))
    with torch.no_grad():
        got, aux = tlm.forward(c["params"], c["cfg"], torch.from_numpy(toks), **kw)
    _close(got, want)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("kw", [dict(remat=True), dict(layout_scan=True),
                                dict(remat=True, layout_scan=True)],
                         ids=["remat", "layout_scan", "both"])
def test_whisper_knobs_match_jax(kw):
    c = zoo_case("whisper-small")
    b = _batch(c["cfg"])
    jl, jg = _jax_grads(lambda p, bb: jencdec.loss_fn(p, c["jcfg"], bb, **kw), c["jparams"], b)
    loss, grads = _port_grads(lambda p, bb: tencdec.loss_fn(p, c["cfg"], bb, **kw), c["params"],
                              b)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
    _assert_grads_close(grads, jg, c["params"])
    jenc = jax.jit(lambda p, f: jencdec.encode(p, c["jcfg"], f, **kw))(
        c["jparams"], jnp.asarray(b["frames"]))
    jlogits = jax.jit(lambda p, t, e: jencdec.decode_train(p, c["jcfg"], t, e, **kw))(
        c["jparams"], jnp.asarray(b["tokens"]), jenc)
    with torch.no_grad():
        enc = tencdec.encode(c["params"], c["cfg"], torch.from_numpy(b["frames"]), **kw)
        logits = tencdec.decode_train(c["params"], c["cfg"], torch.from_numpy(b["tokens"]),
                                      enc, **kw)
    _close(enc, jenc)
    _close(logits, jlogits)


class _OpCount(TorchDispatchMode):
    """Counts the aten ops run under it."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def _backward_ops(arch, **kw):
    """``(bytes saved for the backward outside checkpoints, ops the
    backward ran, 2-D matmuls the backward ran)`` of one loss."""
    c = zoo_case(arch)
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    ws = leaves(c["params"])
    for w in ws:
        w.requires_grad_(True)
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = tlm.loss_fn(c["params"], c["cfg"], {
                k: torch.from_numpy(v) for k, v in _batch(c["cfg"]).items()}, **kw)
        with _OpCount() as count:
            torch.autograd.grad(loss, ws)
    finally:
        for w in ws:
            w.requires_grad_(False)
    mm = sum(count.ops[op] for op in tlm._SAVED_DOTS)
    return saved[0], sum(count.ops.values()), mm


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recomputes_in_the_backward(arch):
    """No remat keeps every activation; "full" keeps only each block's input
    and recomputes the block, 2-D matmuls too; "dots" recomputes the rest
    but no 2-D matmul (their outputs are kept)."""
    none, full, dots = (_backward_ops(arch), _backward_ops(arch, remat=True),
                        _backward_ops(arch, remat=True, remat_policy="dots"))
    assert none[0] > 4 * full[0] and full[0] == dots[0]
    assert full[1] > dots[1] > none[1]
    assert full[2] > dots[2] == none[2]


def test_residual_spec_still_raises():
    """``residual_spec`` no longer raises (the mesh modules are ported): on
    plain tensors the constraint is a no-op, forward and loss bit-equal to
    the default; a spec naming an axis of no mesh is only checked where a
    DTensor meets it (``tests/test_torch_distributed.py``)."""
    c = zoo_case("qwen2.5-3b")
    b = {k: torch.from_numpy(v) for k, v in _batch(c["cfg"]).items()}
    spec = P("data", "model", None)
    assert tlm.loss_fn(c["params"], c["cfg"], b, residual_spec=spec)[0].item() == \
        tlm.loss_fn(c["params"], c["cfg"], b)[0].item()
    assert torch.equal(tlm.forward(c["params"], c["cfg"], b["tokens"], residual_spec=spec)[0],
                       tlm.forward(c["params"], c["cfg"], b["tokens"])[0])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_scan_plan_and_shape_cells_match_jax(arch):
    for cfg, jcfg in ((get_config(arch), jregistry.get_config(arch)),
                      (smoke_config(arch), jregistry.smoke_config(arch))):
        if cfg.is_encdec:
            continue  # no scan_plan: encdec's stacks are homogeneous
        assert tlm.scan_plan(cfg) == jlm.scan_plan(jcfg)
        prefix, unit, n_units, suffix = tlm.scan_plan(cfg)
        assert tlm._layer_order(cfg, True) == list(range(cfg.n_layers)) == (
            prefix + list(range(len(prefix), len(prefix) + unit * n_units)) + suffix)
    assert shape_cells(arch) == jregistry.shape_cells(arch)
    assert list(shape_cells(arch)) == list(SHAPES) == list(JSHAPES)


_JINIT = {True: jencdec.init_encdec, False: jlm.init_lm}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_match_jax(arch):
    cfg, jcfg = get_config(arch), jregistry.get_config(arch)
    meta = flops.meta_params(cfg)
    shapes = jax.eval_shape(lambda: _JINIT[cfg.is_encdec](jax.random.PRNGKey(0), jcfg))
    jflat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    got = list(leaves_with_path(meta))
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in jflat]
    for (path, t), (_, sd) in zip(got, jflat):
        assert t.device.type == "meta" and tuple(t.shape) == tuple(sd.shape), path
        assert str(t.dtype).removeprefix("torch.") == str(sd.dtype), path
    counts = flops.param_counts(cfg, meta)
    want = jflops.param_counts(jcfg, shapes)
    assert counts == want
    assert counts["active"] < counts["total"] if cfg.moe else counts["active"] == counts["total"]
    for name, shape in SHAPES.items():
        assert flops.model_flops(cfg, shape, counts) == jflops.model_flops(
            jcfg, JSHAPES[name], want), name


def test_param_counts_of_a_real_tree_equal_its_meta_twin():
    c = zoo_case("deepseek-v2-lite-16b")
    meta = flops.meta_params(c["cfg"])
    assert flops.param_counts(c["cfg"], c["params"]) == flops.param_counts(c["cfg"], meta)
    # deepseek-v2-lite-16b at full width: 15.706 B parameters, 2.661 B active
    counts = flops.param_counts(get_config("deepseek-v2-lite-16b"),
                                flops.meta_params(get_config("deepseek-v2-lite-16b")))
    assert round(counts["total"] / 1e9, 3) == 15.706 and round(counts["active"] / 1e9, 3) == 2.661
