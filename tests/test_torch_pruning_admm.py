"""The port's pruning half against the JAX package, on the CPU: the four
projections added to the port (Unstructured, Row, NM, BankBalanced),
``structure_from_spec``, the tree paths of ``utils.tree`` against
``jax.tree_util.keystr``, ``PrunePlan``, the mask algebra, ADMM
(``admm_init`` / ``admm_penalty`` / ``admm_update`` / ``hard_prune`` /
``convergence_metrics``) and the sensitivity schedule.

Both packages get the same numpy arrays: the smoke qwen2.5-3b params in the
``init_lm`` layout (``numpy_lm`` of ``tests/test_torch_decode.py``) or
seeded random matrices.  What is held:

* bit-equal: masks and projected weights of every projection, structures
  from specs, leaf paths and their order, plan assignments, ``admm_init``'s
  Z / U, ``admm_update``'s Z / U / rho, ``hard_prune``'s masks and pruned
  weights, ``tree_sparsity_report``, the sensitivity assignment;
* within rtol 1e-5: ``admm_penalty`` and its gradient (sums in another
  order), ``convergence_metrics``, the sensitivity table's loss deltas
  (atol 1e-5: differences of two ~5.5 losses), ``polynomial_schedule``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jsmoke_config
from repro.core import pruning as jpr
from repro.launch.train import default_prune_plan as jdefault_plan
from repro.models import get_model as jget_model
from repro.training.optimizer import AdamWState as JAdamWState
from repro.training.train_loop import TrainState as JTrainState
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import pruning as tpr
from repro_torch.launch.train import default_prune_plan
from repro_torch.models import get_model
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_loop import TrainState
from repro_torch.utils.tree import leaves_with_path, map_with_path
from test_torch_decode import _tree_map, numpy_lm

RTOL = dict(rtol=1e-5, atol=0.0)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _eq(got, want):
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


@pytest.fixture(scope="module")
def lm():
    cfg, jcfg = smoke_config("qwen2.5-3b"), jsmoke_config("qwen2.5-3b")
    pnp = numpy_lm(cfg, seed=5)
    return dict(cfg=cfg, jcfg=jcfg, pnp=pnp, jparams=_tree_map(jnp.asarray, pnp),
                params=lm_params_from_numpy(pnp, device="cpu"))


def _fresh(lm):
    return lm_params_from_numpy(lm["pnp"], device="cpu")


# --------------------------------------------------------------------------- #
# projections and specs                                                        #
# --------------------------------------------------------------------------- #

NEW_CASES = [
    ("unstructured", (jpr.Unstructured(0.75), tpr.Unstructured(0.75)), (64, 96)),
    ("unstructured-ties", (jpr.Unstructured(0.5), tpr.Unstructured(0.5)), (16, 8)),
    ("row", (jpr.Row(0.5), tpr.Row(0.5)), (64, 96)),
    ("row-0.3", (jpr.Row(0.3), tpr.Row(0.3)), (37, 20)),
    ("nm-2:4", (jpr.NM(n_keep=2, m=4), tpr.NM(n_keep=2, m=4)), (64, 96)),
    ("nm-1:8", (jpr.NM(n_keep=1, m=8), tpr.NM(n_keep=1, m=8)), (32, 40)),
    ("bank", (jpr.BankBalanced(0.5, bank=32), tpr.BankBalanced(0.5, bank=32)), (64, 96)),
    ("bank-0.75", (jpr.BankBalanced(0.75, bank=16), tpr.BankBalanced(0.75, bank=16)), (24, 48)),
]


@pytest.mark.parametrize("name,structs,shape", NEW_CASES, ids=[c[0] for c in NEW_CASES])
def test_new_projections_bit_equal_to_jax(name, structs, shape):
    rng = np.random.default_rng(len(name))
    w = rng.standard_normal(shape).astype(np.float32)
    if name.endswith("ties"):  # many equal magnitudes: the index tie-break decides
        w = np.round(w)
    jw, jm = jpr.project(jnp.asarray(w), structs[0])
    tw, tm = tpr.project(torch.from_numpy(w), structs[1])
    _eq(tm, jm)
    _eq(tw, jw)
    assert tuple(tm.shape) == shape and tm.dtype == torch.float32
    kept = float(tm.sum()) / tm.numel()
    assert kept == pytest.approx(1.0 - structs[1].sparsity, abs=0.02)
    _eq(tpr.mask_for(torch.from_numpy(w), structs[1]), jm)


def test_project_validates_like_jax():
    for j, t, shape in [(jpr.NM(2, 4), tpr.NM(2, 4), (6, 8)),
                        (jpr.BankBalanced(0.5, bank=32), tpr.BankBalanced(0.5, bank=32), (8, 40)),
                        (jpr.Row(0.5), tpr.Row(0.5), (4, 4, 2))]:
        with pytest.raises(ValueError):
            jpr.project(jnp.zeros(shape), j)
        with pytest.raises(ValueError):
            tpr.project(torch.zeros(shape), t)


SPECS = [
    {"kind": "unstructured", "sparsity": 0.7},
    {"kind": "row", "sparsity": 0.4},
    {"kind": "filter", "sparsity": 0.4},
    {"kind": "column", "sparsity": 0.6},
    {"kind": "channel", "sparsity": 0.25},
    {"kind": "block", "sparsity": 0.5, "bm": 64, "bn": 32, "balanced": False},
    {"kind": "nm", "n_keep": 1, "m": 4},
    {"kind": "pattern", "sparsity": 0.5, "connectivity": 0.2,
     "patterns": [[1, 3, 4, 5], [4, 5, 7, 8]]},
    {"kind": "bank", "sparsity": 0.5, "bank": 64},
]


@pytest.mark.parametrize("spec", SPECS, ids=[s["kind"] for s in SPECS])
def test_structure_from_spec_equals_jax(spec):
    j, t = jpr.structure_from_spec(spec), tpr.structure_from_spec(spec)
    assert type(t).__name__ == type(j).__name__
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.storage_format, t.reorderable, t.kind) == (j.storage_format, j.reorderable, j.kind)
    assert "kind" in spec  # the spec is not consumed


def test_structure_from_spec_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown structure kind"):
        tpr.structure_from_spec({"kind": "diagonal"})


# --------------------------------------------------------------------------- #
# tree paths                                                                   #
# --------------------------------------------------------------------------- #


def _jax_paths(tree):
    return [(jax.tree_util.keystr(p), leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_leaf_paths_equal_keystr_over_the_smoke_params(lm):
    want = _jax_paths(lm["jparams"])
    got = list(leaves_with_path(lm["params"]))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert "['layers'][0]['attn']['w_q']['w']" in dict(got)
    for (_, t), (_, j) in zip(got, want):
        assert tuple(t.shape) == tuple(j.shape)


def test_leaf_paths_of_a_train_state_equal_keystr():
    """Dataclass fields, named-tuple fields, ``None`` subtrees and static
    fields as the JAX package's registered TrainState / AdmmState give them."""
    jstate = (JTrainState(
        params={"b": [{"w": 1, "a": None}], "a": 2},
        opt=JAdamWState(jnp.int32(0), {"x": 1}, {"x": 2}),
        admm=jpr.AdmmState(z={"x": None, "y": 3}, u={"x": None, "y": 4}, rho=1.0,
                           n_updates=0, structures={"k": jpr.Row()}),
        masks=None), {"data_step": 3})
    tstate = (TrainState(
        params={"b": [{"w": 1, "a": None}], "a": 2},
        opt=AdamWState(0, {"x": 1}, {"x": 2}),
        admm=tpr.AdmmState(z={"x": None, "y": 3}, u={"x": None, "y": 4}, rho=1.0,
                           n_updates=0, structures={"k": tpr.Row()}),
        masks=None), {"data_step": 3})
    want = [(p, int(v)) for p, v in _jax_paths(jstate)]
    assert [(p, int(v)) for p, v in leaves_with_path(tstate)] == want


def test_map_with_path_keeps_structure_and_none():
    tree = {"z": [1, None, (2, 3)], "a": {"k": 4}}
    masks = {"z": [None, None, (5, None)], "a": None}
    seen = []
    out = map_with_path(lambda p, x, m: seen.append((p, m)) or x * 10, tree, masks)
    assert out == {"a": {"k": 40}, "z": [10, None, (20, 30)]}
    assert seen == [("['a']['k']", None), ("['z'][0]", None), ("['z'][2][0]", 5),
                    ("['z'][2][1]", None)]


# --------------------------------------------------------------------------- #
# plans                                                                        #
# --------------------------------------------------------------------------- #


def _assign_equal(jplan, tplan, jparams, params):
    want = jplan.assign(jparams)
    got = tplan.assign(params)
    assert list(got) == list(want)
    for path in want:
        assert dataclasses.asdict(got[path]) == dataclasses.asdict(want[path])
        assert type(got[path]).__name__ == type(want[path]).__name__
    return got


def test_default_plan_assigns_like_jax(lm):
    got = _assign_equal(jdefault_plan(0.5), default_prune_plan(0.5), lm["jparams"], lm["params"])
    # gate / up (128 x 256) column-pruned, q / o (128 x 128) in 64 x 64 blocks
    assert len(got) == 4 * lm["cfg"].n_layers
    assert isinstance(got["['layers'][1]['ffn']['w_up']['w']"], tpr.Column)
    assert isinstance(got["['layers'][0]['attn']['w_o']['w']"], tpr.Block)


def test_rule_plans_assign_like_jax(lm):
    rules = [("*ffn*w_down*", {"kind": "row", "sparsity": 0.3}),
             ("*attn*w_[kv]*", {"kind": "nm", "n_keep": 2, "m": 4}),  # '[' is literal
             ("*attn*['w_k']*", {"kind": "bank", "sparsity": 0.5, "bank": 32}),
             ("*attn*", {"kind": "block", "sparsity": 0.5, "bm": 48, "bn": 32}),  # misfit
             ("*lm_head*", tpr.Unstructured(0.8))]
    jrules = [(p, s if isinstance(s, dict) else jpr.Unstructured(0.8)) for p, s in rules]
    for min_size in (4096, 16384):
        _assign_equal(jpr.PrunePlan.from_rules(jrules, min_size=min_size),
                      tpr.PrunePlan.from_rules(rules, min_size=min_size),
                      lm["jparams"], lm["params"])


@pytest.mark.parametrize("path,pat", [
    ("['layers'][0]['attn']['w_q']['w']", "*attn*w_q*['w']"),
    ("['layers'][0]['attn']['w_q']['b']", "*attn*w_q*['w']"),
    ("['layers'][0]['attn']['w_q']['w']", "*['w']"),
    ("['layers'][0]['attn']['w_q']['w']", "['layers'][0]*"),
    ("['layers'][10]['ffn']", "['layers'][1]*"),
    ("['layers'][0]['ffn']", "*[a-z]*"),
])
def test_glob_match_only_star_is_special(path, pat):
    assert tpr.PrunePlan._glob_match(path, pat) == jpr.PrunePlan._glob_match(path, pat)


# --------------------------------------------------------------------------- #
# ADMM                                                                         #
# --------------------------------------------------------------------------- #

ADMM_CFG = dict(rho=1e-2, rho_ramp=1.2, rho_max=1.0, update_every=2)


def _state_pair(lm):
    jst = jpr.admm_init(lm["jparams"], jdefault_plan(0.5), jpr.AdmmConfig(**ADMM_CFG))
    tst = tpr.admm_init(_fresh(lm), default_prune_plan(0.5), tpr.AdmmConfig(**ADMM_CFG))
    return jst, tst


def _zu_equal(jst, tst):
    for tree_t, tree_j in ((tst.z, jst.z), (tst.u, jst.u)):
        jflat = dict(_jax_paths(tree_j))
        tflat = dict(leaves_with_path(tree_t))
        assert list(tflat) == list(jflat)
        for path in jflat:
            _eq(tflat[path], jflat[path])
            assert tflat[path].dtype == torch.float32


def test_admm_init_bit_equal(lm):
    jst, tst = _state_pair(lm)
    _zu_equal(jst, tst)
    assert tst.rho == float(jst.rho) and tst.n_updates == int(jst.n_updates) == 0
    assert list(tst.structures) == list(jst.structures)
    # dense leaves are None in Z and U
    assert tst.z["embed"]["table"] is None and tst.u["layers"][0]["attn"]["w_k"]["w"] is None


def test_admm_update_bit_equal_over_several_updates(lm):
    jst, tst = _state_pair(lm)
    jcfg, tcfg = jpr.AdmmConfig(**ADMM_CFG), tpr.AdmmConfig(**ADMM_CFG)
    rng = np.random.default_rng(11)
    pnp = lm["pnp"]
    for _ in range(3):
        # move the weights (as training would) and update
        pnp = _tree_map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                        pnp)
        jst = jpr.admm_update(_tree_map(jnp.asarray, pnp), jst, jcfg)
        tst = tpr.admm_update(lm_params_from_numpy(pnp, device="cpu"), tst, tcfg)
        _zu_equal(jst, tst)
        assert tst.rho == float(jst.rho) and tst.n_updates == int(jst.n_updates)
    assert tst.rho == pytest.approx(1e-2 * 1.2 ** 3, rel=1e-6)


def test_admm_penalty_and_its_gradient_match_jax(lm):
    jst, tst = _state_pair(lm)
    jcfg, tcfg = jpr.AdmmConfig(**ADMM_CFG), tpr.AdmmConfig(**ADMM_CFG)
    rng = np.random.default_rng(2)
    pnp = _tree_map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
                    lm["pnp"])
    jst = jpr.admm_update(_tree_map(jnp.asarray, pnp), jst, jcfg)
    tst = tpr.admm_update(lm_params_from_numpy(pnp, device="cpu"), tst, tcfg)
    jp = _tree_map(jnp.asarray, pnp)
    jval, jgrad = jax.value_and_grad(lambda p: jpr.admm_penalty(p, jst))(jp)
    params = lm_params_from_numpy(pnp, device="cpu")
    ws = [w.requires_grad_(True) for _, w in leaves_with_path(params)]
    val = tpr.admm_penalty(params, tst)
    grads = torch.autograd.grad(val, ws, allow_unused=True)
    np.testing.assert_allclose(val.item(), float(jval), **RTOL)
    for (path, jg), g in zip(_jax_paths(jgrad), grads):
        if g is None:  # a dense leaf: JAX's gradient is zero
            assert not np.asarray(jg).any(), path
        else:
            np.testing.assert_allclose(_np(g), np.asarray(jg), rtol=1e-6, atol=1e-9)
    jm = jpr.convergence_metrics(jp, jst)
    tm = tpr.convergence_metrics(params, tst)
    np.testing.assert_allclose(tm["primal_residual"].item(), float(jm["primal_residual"]),
                               **RTOL)
    assert tm["rho"] == float(jm["rho"])


def test_admm_penalty_keeps_the_weight_dtype_in_backward():
    w = torch.randn(64, 64, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    st = tpr.admm_init({"w": w}, tpr.PrunePlan.from_rules([("*", tpr.Row(0.5))], 16),
                       tpr.AdmmConfig(rho=0.5))
    wl = w.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(tpr.admm_penalty({"w": wl}, st), [wl])
    want = ((w.float() - st.z["w"] + st.u["w"]) * 0.5).to(torch.bfloat16)
    assert g.dtype == torch.bfloat16 and torch.equal(g, want)


def test_hard_prune_and_report_bit_equal(lm):
    jst, tst = _state_pair(lm)
    jpruned, jmasks = jpr.hard_prune(lm["jparams"], jst)
    pruned, masks = tpr.hard_prune(lm["params"], tst)
    jm = dict(_jax_paths(jmasks))
    tm = dict(leaves_with_path(masks))
    assert list(tm) == list(jm) and len(tm) == 8
    for path in jm:
        _eq(tm[path], jm[path])
        assert tm[path].dtype == torch.float32
    for (path, jw), (tpath, w) in zip(_jax_paths(jpruned), leaves_with_path(pruned)):
        assert path == tpath
        _eq(w, jw)
    want = jpr.tree_sparsity_report(jpruned, jmasks)
    got = tpr.tree_sparsity_report(pruned, masks)
    assert got == want
    assert got["pruned_global"] == pytest.approx(0.5)
    # the masks count: a raw weight that drifted off zero changes nothing
    drifted = map_with_path(lambda _, w: w + 1.0, pruned)
    assert tpr.tree_sparsity_report(drifted, masks) == got


def test_mask_algebra_matches_jax(lm):
    jst, tst = _state_pair(lm)
    _, jmasks = jpr.hard_prune(lm["jparams"], jst)
    _, masks = tpr.hard_prune(lm["params"], tst)
    jout = jpr.apply_masks(lm["jparams"], jmasks)
    out = tpr.apply_masks(lm["params"], masks)
    for (p, j), (_, t) in zip(_jax_paths(jout), leaves_with_path(out)):
        _eq(t, j)
    jg = jpr.mask_gradients(lm["jparams"], jmasks)
    for (p, j), (_, t) in zip(_jax_paths(jg), leaves_with_path(tpr.mask_gradients(
            lm["params"], masks))):
        _eq(t, j)
    assert tpr.count_params(lm["params"]) == jpr.count_params(lm["jparams"])
    m = masks["layers"][0]["attn"]["w_q"]["w"]
    assert tpr.sparsity(m) == pytest.approx(jpr.sparsity(jnp.asarray(m.numpy())))
    a, b = torch.tensor([1.0, 0.0, 1.0]), torch.tensor([1.0, 1.0, 0.0])
    assert torch.equal(tpr.combine_masks(a, b), torch.tensor([1.0, 0.0, 0.0]))
    assert tpr.combine_masks(None, b) is b and tpr.combine_masks(a, None) is a


# --------------------------------------------------------------------------- #
# schedule                                                                     #
# --------------------------------------------------------------------------- #


def test_sensitivity_scan_and_assignment_match_jax(lm):
    cfg, jcfg = lm["cfg"], lm["jcfg"]
    tok = np.random.default_rng(3).integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tok[:, :-1]), "labels": jnp.asarray(tok[:, 1:])}
    batch = {"tokens": torch.from_numpy(tok[:, :-1]), "labels": torch.from_numpy(tok[:, 1:])}
    jloss = jax.jit(lambda p: jget_model(jcfg).loss(p, jbatch)[0])
    model = get_model(cfg, device="cpu")
    cands = {
        "['layers'][0]['ffn']['w_gate']['w']": (jpr.Column(0.5), tpr.Column(0.5)),
        "['layers'][1]['attn']['w_q']['w']": (jpr.Block(0.5, 64, 64), tpr.Block(0.5, 64, 64)),
        "['layers'][1]['ffn']['w_down']['w']": (jpr.Row(0.5), tpr.Row(0.5)),
    }
    jres = jpr.sensitivity_scan(jloss, lm["jparams"], {k: v[0] for k, v in cands.items()})
    res = tpr.sensitivity_scan(lambda p: model.loss(p, batch)[0], lm["params"],
                               {k: v[1] for k, v in cands.items()})
    assert res.base_loss == pytest.approx(jres.base_loss, rel=1e-5)
    assert list(res.table) == list(jres.table)
    for path in jres.table:
        assert list(res.table[path]) == list(jres.table[path])  # Block skips 0.3 / 0.7 / 0.9
        np.testing.assert_allclose(list(res.table[path].values()),
                                   list(jres.table[path].values()), rtol=0, atol=1e-5)
    sizes = {p: int(np.prod(lm["pnp"]["layers"][0]["ffn"]["w_gate"]["w"].shape))
             for p in cands}
    for target in (0.2, 0.5, 0.7):
        assert tpr.assign_sparsities(res, sizes, target) == jpr.assign_sparsities(
            jres, sizes, target)
    assert tpr.assign_sparsities(tpr.SensitivityResult({}, 0.0), {}, 0.5) == {}


@pytest.mark.parametrize("step", [0, 3, 10, 17, 40])
def test_polynomial_schedule_matches_jax(step):
    want = float(jpr.polynomial_schedule(jnp.asarray(step), 5, 25, 0.8))
    got = tpr.polynomial_schedule(step, 5, 25, 0.8)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, **RTOL)
    assert tpr.polynomial_schedule(torch.tensor(step), 5, 25, 0.8).item() == got.item()
