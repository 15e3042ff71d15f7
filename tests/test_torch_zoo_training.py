"""Training the rest of the zoo in the port against the JAX package, on the
CPU: one ADMM train step per family at its f32 smoke config, a MoE batch
that overflows expert capacity, and a checkpoint round trip of a zoo
``TrainState``.  (The launcher's whole pipeline per family is in
``tests/test_torch_zoo_launcher.py``.)

Both packages get one numpy tree (``numpy_tree`` in the JAX package's
layout, ``tests/test_torch_zoo_models.py``) and the same
``SyntheticPipeline`` batches (a VLM's patch embeddings and whisper's
frames included).  What is held, and why each tolerance:

* one ``make_train_step`` with the JAX recipe ``default_prune_plan(0.5)``
  and a Z/U update (``update_every=1``) against JAX's jitted step: loss,
  ce, aux, grad norm, lr, primal residual and rho within rtol 1e-5 (the same
  f32 ops summed in another order); params within ``2 * lr`` of JAX's (at
  step 1 Adam's update is ``g / (|g| + eps)``, so a gradient element at
  rounding level can flip sign) and 99.9% of them within 1e-6; Z keeps the
  same units.  The recipe leaves every MoE expert stack dense, matches
  nothing in Mamba-2 and no ``w_q`` under q-LoRA (deepseek-v2-236b), in
  both packages;
* a deepseek-v2-lite batch whose router overflows capacity (token-slots
  dropped, checked): loss and aux within rtol 1e-5, every gradient leaf
  within 1e-5 x max(1, max|g|) of ``jax.value_and_grad``;
* a checkpoint of a zoo state after two ADMM steps: restored
  ``torch.equal`` leaf by leaf, and a step from the restored state equal to
  a step from the saved one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning as jpr
from repro.launch.train import default_prune_plan as jdefault_plan
from repro.models import transformer as jlm
from repro.training import optimizer as jopt
from repro.training.train_loop import init_train_state as jinit_state
from repro.training.train_loop import make_train_step as jmake_step
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import pruning as tpr
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.launch.train import default_prune_plan
from repro_torch.models import ffn as tffn
from repro_torch.models import transformer as tlm
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optimizer as topt
from repro_torch.training.train_loop import init_train_state, make_train_step
from repro_torch.utils.tree import leaves, leaves_with_path, map_with_path
from test_torch_zoo_models import zoo_case

#: the families slice 12 did not train: qk_norm, MLA + MoE (q-LoRA in 236b's
#: smoke config), the prefix-LM VLM, Mamba-2, the RG-LRU hybrid, Whisper
ZOO = ("qwen3-14b", "deepseek-v2-lite-16b", "deepseek-v2-236b", "paligemma-3b",
       "mamba2-1.3b", "recurrentgemma-9b", "whisper-small")
BATCH, SEQ = 4, 16
ADMM = dict(rho=1e-2, rho_ramp=1.2, rho_max=1.0)
OPT = dict(lr=1e-3, total_steps=10, warmup_steps=5)


def _np(x):
    return x.detach().float().numpy()


def fresh_params(arch):
    """The arch's numpy tree as new port tensors (a train step updates its
    params in place; the cached ``zoo_case`` params stay untouched)."""
    return lm_params_from_numpy(zoo_case(arch)["pnp"], device="cpu")


def batches(cfg, n, batch=BATCH, seq=SEQ, seed=0):
    pipe = SyntheticPipeline(cfg, batch=batch, seq=seq + 1, seed=seed)
    return [pipe.next() for _ in range(n)]


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


#: the JAX package's jitted train steps, one compile per (arch, step kind)
_JSTEPS = {}


def jax_step(arch, every=None):
    """JAX's jitted ``make_train_step`` for ``arch``: ADMM with a Z/U update
    every ``every`` steps, or the plain (masked fine-tune) step."""
    key = (arch, every)
    if key not in _JSTEPS:
        acfg = None if every is None else jpr.AdmmConfig(update_every=every, **ADMM)
        _JSTEPS[key] = jax.jit(jmake_step(zoo_case(arch)["jmodel"].loss,
                                          jopt.AdamWConfig(**OPT), admm_cfg=acfg))
    return _JSTEPS[key]


def _assert_params_close(params, jparams, lr):
    diffs = []
    for (path, want), (tpath, got) in zip(
            jax.tree_util.tree_flatten_with_path(jparams)[0], leaves_with_path(params)):
        assert jax.tree_util.keystr(path) == tpath
        d = np.abs(_np(got) - np.asarray(want, np.float32)).ravel()
        assert d.max() <= 2 * lr + 1e-6, (tpath, d.max())
        diffs.append(d)
    d = np.concatenate(diffs)
    assert (d <= 1e-6).mean() >= 0.999, (d > 1e-6).mean()


@pytest.mark.parametrize("arch", ZOO)
def test_admm_train_step_matches_jax(arch):
    c = zoo_case(arch)
    b = batches(c["cfg"], 1)[0]
    jstate = jinit_state(c["jparams"], jopt.AdamWConfig(**OPT),
                         admm_cfg=jpr.AdmmConfig(update_every=1, **ADMM),
                         prune_plan=jdefault_plan(0.5))
    jstate, jm = jax_step(arch, every=1)(jstate, _j(b))
    acfg = tpr.AdmmConfig(update_every=1, **ADMM)
    state = init_train_state(fresh_params(arch), topt.AdamWConfig(**OPT), admm_cfg=acfg,
                             prune_plan=default_prune_plan(0.5))
    # the recipe's leaves: never an expert stack, nothing in Mamba-2, no
    # w_q under q-LoRA -- the same set as JAX's
    pruned = sorted(state.admm.structures)
    assert pruned == sorted(jstate.admm.structures)
    assert not [p for p in pruned if "['experts']" in p]
    if c["cfg"].ssm is not None:
        assert pruned == []
    if c["cfg"].q_lora_rank:
        assert not [p for p in pruned if "w_q" in p]
    state, m = make_train_step(c["model"].loss, topt.AdamWConfig(**OPT), admm_cfg=acfg)(
        state, _t(b))
    assert set(m) == set(jm)
    assert ("aux" in m) == (not c["cfg"].is_encdec)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-9, err_msg=k)
    assert state.opt.step == int(jstate.opt.step) == 1
    assert state.admm.n_updates == int(jstate.admm.n_updates) == 1
    _assert_params_close(state.params, jstate.params,
                         topt.cosine_schedule(0, topt.AdamWConfig(**OPT)))
    jz = jax.tree_util.tree_flatten_with_path(jstate.admm.z)[0]
    tz = list(leaves_with_path(state.admm.z))
    assert [jax.tree_util.keystr(p) for p, _ in jz] == [p for p, _ in tz]
    for (_, want), (path, got) in zip(jz, tz):
        np.testing.assert_array_equal(_np(got) != 0, np.asarray(want) != 0, err_msg=path)


def test_moe_capacity_overflow_gradients_match_jax(monkeypatch):
    arch = "deepseek-v2-lite-16b"
    c = zoo_case(arch)
    b = batches(c["cfg"], 1, batch=2, seq=64, seed=3)[0]
    dropped = []
    dispatch = tffn._dispatch

    def spy(expert_idx, n_experts, capacity):
        out = dispatch(expert_idx, n_experts, capacity)
        dropped.append(int((~out[2]).sum()))
        return out

    monkeypatch.setattr(tffn, "_dispatch", spy)
    params = c["params"]
    ws = leaves(params)
    for w in ws:
        w.requires_grad_(True)
    try:
        loss, m = tlm.loss_fn(params, c["cfg"], _t(b))
        grads = torch.autograd.grad(loss, ws)
    finally:
        for w in ws:
            w.requires_grad_(False)
    n_moe = c["cfg"].n_layers - c["cfg"].moe.first_dense
    assert len(dropped) == n_moe and sum(dropped) > 0, dropped  # capacity overflowed
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, bb: jlm.loss_fn(p, c["jcfg"], bb), has_aux=True))(c["jparams"], _j(b))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(m["aux"].item(), float(jm["aux"]), rtol=1e-5)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in leaves_with_path(params)]
    for (path, want), got in zip(jflat, grads):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(want).max())),
                                   err_msg=jax.tree_util.keystr(path))


def _copy_state(state):
    return map_with_path(lambda _, x: x.clone() if isinstance(x, torch.Tensor) else x, state)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mamba2-1.3b", "whisper-small"])
def test_zoo_train_state_checkpoint_round_trip(arch, tmp_path):
    c = zoo_case(arch)
    opt, acfg = topt.AdamWConfig(**OPT), tpr.AdmmConfig(update_every=2, **ADMM)

    def fresh():
        return init_train_state(fresh_params(arch), opt, admm_cfg=acfg,
                                prune_plan=default_prune_plan(0.5))

    step = make_train_step(c["model"].loss, opt, admm_cfg=acfg)
    bs = batches(c["cfg"], 3)
    state = fresh()
    for b in bs[:2]:
        state, _ = step(state, _t(b))
    mgr = tckpt.CheckpointManager(str(tmp_path), save_every=2, keep=1)
    mgr.maybe_save(2, (state, {"data_step": 2}))
    (restored, data), at = mgr.restore_latest((fresh(), {"data_step": 0}))
    assert at == 2 and data == {"data_step": 2}
    assert restored.opt.step == 2 and restored.admm.n_updates == 1
    assert restored.admm.structures == state.admm.structures
    saved, got = list(leaves_with_path(state)), list(leaves_with_path(restored))
    assert [p for p, _ in saved] == [p for p, _ in got]
    for (path, a), (_, r) in zip(saved, got):
        assert torch.equal(a, r) if isinstance(a, torch.Tensor) else a == r, path
    # one more step from each: the same state, bit for bit
    a_state, ma = step(_copy_state(state), _t(bs[2]))
    b_state, mb = step(restored, _t(bs[2]))
    assert ma["loss"].item() == mb["loss"].item()
    assert all(torch.equal(x, y) for x, y in zip(leaves(a_state.params), leaves(b_state.params)))
