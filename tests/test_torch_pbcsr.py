"""The port's block-sparse (PBCSR) slice against the JAX package, on the CPU.

Both sides get the same arrays, drawn from numpy seeds.  What is held:

* Block masks (``project``) bit-equal, balanced and global top-k;
* ``PBCSR.from_dense`` values and block rows bit-equal, ``to_dense``
  round-trips, and the byte counts agree;
* ``plan_reorder`` order, bands and waste equal, and the column permutes
  equal;
* ``pbcsr_to_dense_ref`` / ``bsr_matmul_ref`` equal the JAX references;
* ``ops.bsr_matmul`` (the plain route: every band through the kernel
  wrapper's plain version) within 1e-5 of the JAX ops wrapper with the
  Pallas kernel in interpret mode -- with bands, an empty band, an
  epilogue add, leading batch dims;
* ``test_graph_compiler._mlp_graph`` pruned with Block / Column / Channel:
  the optimized graph equals the JAX package's, and both backends' plans are
  within 1e-4 of the JAX plans.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import compile_plan as jcompile_plan
from repro.core.graph.passes import optimize as joptimize
from repro.core.pruning import Block as JBlock
from repro.core.pruning import Channel as JChannel
from repro.core.pruning import Column as JColumn
from repro.core.pruning import project as jproject
from repro.core.sparse import formats as jformats
from repro.core.sparse import packing as jpacking
from repro.core.sparse import reorder as jreorder
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.graph import GraphBuilder, PassContext, PassManager, compile_plan
from repro_torch.core.pruning import Block, Channel, Column, project
from repro_torch.core.sparse import PBCSR, block_mask, dense_nbytes, plan_reorder
from repro_torch.core.sparse import reorder as treorder
from repro_torch.kernels import bsr_matmul as tbsr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.obs import metrics as tmetrics
from test_graph_compiler import _mlp_graph

T = torch.from_numpy
J = jnp.asarray


@pytest.fixture(autouse=True)
def _port_registry():
    """The port keeps its own metrics registry and launch counters; restore
    them around each test."""
    snap = tmetrics.registry().dump_state()
    tops.reset_kernel_launches()
    try:
        yield
    finally:
        tmetrics.registry().load_state(snap)


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _packed(seed, k, n, st, jst):
    """A weight and its Block mask from both packages."""
    w = _arr(np.random.default_rng(seed), k, n)
    _, mask = project(T(w), st)
    _, jmask = jproject(J(w), jst)
    return w, mask, jmask


# --------------------------------------------------------------------------- #
# masks, formats, reorder                                                      #
# --------------------------------------------------------------------------- #

#: (K, N, bm, bn, sparsity)
MASK_CASES = [(256, 512, 128, 128, 0.5), (128, 128, 32, 32, 0.5), (192, 96, 64, 32, 0.7),
              (64, 256, 8, 16, 0.3)]


@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("case", MASK_CASES, ids=[f"{c[0]}x{c[1]}b{c[2]}x{c[3]}" for c in
                                                  MASK_CASES])
def test_block_masks_bit_equal_to_jax(case, balanced):
    k, n, bm, bn, sp = case
    w, mask, jmask = _packed(k + n + bm, k, n, Block(sp, bm=bm, bn=bn, balanced=balanced),
                             JBlock(sp, bm=bm, bn=bn, balanced=balanced))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    bmask = block_mask(mask, bm, bn).numpy()
    np.testing.assert_array_equal(bmask, np.asarray(jpacking.block_mask(jmask, bm, bn)))
    kept = bmask.sum(axis=0)
    if balanced:  # every block-column keeps the same count
        assert len(set(kept.tolist())) == 1
    assert bmask.sum() == (Block(sp).n_kept(k // bm) * (n // bn) if balanced
                           else Block(sp).n_kept((k // bm) * (n // bn)))


@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("case", MASK_CASES, ids=[f"{c[0]}x{c[1]}b{c[2]}x{c[3]}" for c in
                                                  MASK_CASES])
def test_pbcsr_payload_bit_equal_and_round_trips(case, balanced):
    k, n, bm, bn, sp = case
    w, mask, jmask = _packed(k * 3 + n, k, n, Block(sp, bm=bm, bn=bn, balanced=balanced),
                             JBlock(sp, bm=bm, bn=bn, balanced=balanced))
    f = PBCSR.from_dense(T(w), mask, bm, bn)
    jf = jformats.PBCSR.from_dense(J(w), jmask, bm, bn)
    np.testing.assert_array_equal(f.values.numpy(), np.asarray(jf.values))
    np.testing.assert_array_equal(f.block_rows.numpy(), np.asarray(jf.block_rows))
    assert f.block_rows.dtype == torch.int32 and f.shape == (k, n)
    np.testing.assert_array_equal(f.to_dense().numpy(), w * mask.numpy())
    np.testing.assert_array_equal(f.to_dense().numpy(), np.asarray(jf.to_dense()))
    assert (f.n_blocks, f.padded_blocks, f.nbytes, f.nbytes_padded) == (
        jf.n_blocks, jf.padded_blocks, jf.nbytes, jf.nbytes_padded)
    np.testing.assert_array_equal(
        tref.pbcsr_to_dense_ref(f.values, f.block_rows, k).numpy(),
        np.asarray(jref.pbcsr_to_dense_ref(jf.values, jf.block_rows, k)))


def test_pbcsr_packs_bf16_and_rejects_untiled_weights():
    rng = np.random.default_rng(0)
    w = T(_arr(rng, 64, 64)).to(torch.bfloat16)
    _, mask = project(w, Block(0.5, bm=16, bn=16))
    f = PBCSR.from_dense(w, mask, 16, 16)
    assert f.values.dtype == torch.bfloat16
    assert torch.equal(f.to_dense(), w * mask)
    assert f.nbytes == f.n_blocks * (16 * 16 * 2 + 4)
    assert dense_nbytes((64, 64)) == 64 * 64 * 2 == jformats.dense_nbytes((64, 64))
    assert dense_nbytes((3, 5), torch.float32) == 60
    with pytest.raises(ValueError, match="do not tile"):
        PBCSR.from_dense(w[:, :40], mask[:, :40], 16, 16)


def _reorder_masks():
    rng = np.random.default_rng(7)
    out = [rng.random((8, 12)) < p for p in (0.2, 0.5, 0.8)]
    out.append(np.ones((4, 6), bool))
    skew = np.zeros((6, 10), bool)
    for j in range(10):
        skew[: (j * 7) % 6, j] = True  # counts 0..5: an empty band
    out.append(skew)
    return out


@pytest.mark.parametrize("max_bands", [1, 2, 4])
@pytest.mark.parametrize("idx", range(5))
def test_plan_reorder_equals_jax(idx, max_bands):
    bmask = _reorder_masks()[idx]
    plan = plan_reorder(bmask, max_bands=max_bands, bm=16, bn=8)
    jplan = jreorder.plan_reorder(bmask, max_bands=max_bands, bm=16, bn=8)
    np.testing.assert_array_equal(plan.order, jplan.order)
    assert [(b.start, b.stop, b.count) for b in plan.bands] == [
        (b.start, b.stop, b.count) for b in jplan.bands]
    assert (plan.waste_before, plan.waste_after, plan.identity) == (
        jplan.waste_before, jplan.waste_after, jplan.identity)
    assert treorder.balance_stats(bmask) == jreorder.balance_stats(bmask)


def test_column_permutes_equal_jax():
    rng = np.random.default_rng(3)
    w = _arr(rng, 24, 32)
    order = rng.permutation(4).astype(np.int32)
    np.testing.assert_array_equal(treorder.apply_column_perm(T(w), order, 8).numpy(),
                                  np.asarray(jreorder.apply_column_perm(J(w), order, 8)))
    np.testing.assert_array_equal(treorder.invert_column_perm(order),
                                  jreorder.invert_column_perm(order))
    wn = _arr(rng, 32, 5)
    np.testing.assert_array_equal(treorder.fold_perm_into_next(T(wn), order, 8).numpy(),
                                  np.asarray(jreorder.fold_perm_into_next(J(wn), order, 8)))


# --------------------------------------------------------------------------- #
# references and the ops wrapper                                               #
# --------------------------------------------------------------------------- #


def _bsr_operands(seed, m, k, n, bm, bn, sp=0.5, balanced=False):
    rng = np.random.default_rng(seed)
    w = _arr(rng, k, n, scale=k ** -0.5)
    _, jmask = jproject(J(w), JBlock(sp, bm=bm, bn=bn, balanced=balanced))
    jf = jformats.PBCSR.from_dense(J(w), jmask, bm, bn)
    x = _arr(rng, m, k)
    b = _arr(rng, n, scale=0.1)
    return x, np.array(jf.values), np.array(jf.block_rows), b, rng


def test_bsr_matmul_ref_equals_jax_ref():
    x, v, r, b, _ = _bsr_operands(0, 6, 128, 96, 32, 16)
    got = tref.bsr_matmul_ref(T(x), T(v), T(r), T(b), activation="gelu")
    want = jref.bsr_matmul_ref(J(x), J(v), J(r), J(b), activation="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _skewed_operands(seed):
    """A packed weight with pads and an empty band: block-column counts
    0, 1, 3, 3 at bm = bn = 16 (the reorder pass's bands of it)."""
    rng = np.random.default_rng(seed)
    k, n, bm, bn = 64, 64, 16, 16
    bmask = np.zeros((4, 4), bool)
    bmask[[1], 1] = True
    bmask[[0, 2, 3], 2] = True
    bmask[[0, 1, 3], 3] = True
    mask = np.kron(bmask, np.ones((bm, bn), np.float32))
    w = _arr(rng, k, n, scale=k ** -0.5)
    plan = jreorder.plan_reorder(bmask, max_bands=4, bm=bm, bn=bn)
    jf = jformats.PBCSR.from_dense(J(w), J(mask), bm, bn)
    bands = tuple((b.start, b.stop, b.count) for b in plan.bands)
    assert plan.identity and any(c == 0 for _, _, c in bands)
    return np.array(jf.values), np.array(jf.block_rows), bands, rng


#: name -> (lead, act, bias, bands, epilogue steps)
OPS_CASES = {
    "no-bands relu bias": ((5,), "relu", True, False, ()),
    "bands + empty band": ((7,), None, True, True, ()),
    "bands + epilogue add": ((2, 3), "silu", False, True, (("add", 0),)),
    "bands + add, mul, gelu": ((9,), None, True, True,
                               (("add", 0), ("mul", 1), ("activation", "gelu"))),
}


@pytest.mark.parametrize("name", sorted(OPS_CASES))
def test_ops_bsr_matmul_matches_jax_interpret(name):
    lead, act, use_bias, use_bands, steps = OPS_CASES[name]
    v, r, bands, rng = _skewed_operands(len(name))
    n_sides = len({s[1] for s in steps if s[0] in ("add", "mul")})
    x = _arr(rng, *lead, 64)
    b = _arr(rng, 64, scale=0.1) if use_bias else None
    sides = [_arr(rng, *lead, 64) for _ in range(n_sides)]
    kw = dict(activation=act, epilogue=steps, bands=bands if use_bands else None)
    want = jops.bsr_matmul(J(x), J(v), J(r), None if b is None else J(b),
                           epilogue_sides=[J(s) for s in sides], interpret=True, **kw)
    got = tops.bsr_matmul(T(x), T(v), T(r), None if b is None else T(b),
                          epilogue_sides=[T(s) for s in sides], **kw)
    assert tuple(got.shape) == (*lead, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert tops.kernel_launch_counts()["bsr_matmul"] == 0  # plain versions on the CPU


def test_ops_bsr_matmul_rejects_bands_that_do_not_tile():
    v, r, bands, rng = _skewed_operands(0)
    x = T(_arr(rng, 3, 64))
    with pytest.raises(ValueError, match="do not tile"):
        tops.bsr_matmul(x, T(v), T(r), bands=((0, 2, 3),))
    with pytest.raises(ValueError, match="do not tile"):
        tops.bsr_matmul(x, T(v), T(r), bands=((0, 2, 3), (3, 4, 3)))


def test_kernel_wrapper_writes_one_band_and_checks_its_arguments():
    v, r, bands, rng = _skewed_operands(1)
    x, b = T(_arr(rng, 5, 64)), T(_arr(rng, 64))
    out = torch.full((5, 64), 7.0)
    start, stop, count = bands[-1]
    got = tbsr.bsr_matmul(x, T(v), T(r), b, band=(start, stop, count), out=out)
    assert got is out
    assert torch.all(out[:, : start * 16] == 7.0)  # other bands untouched
    full = tbsr.bsr_matmul(x, T(v), T(r), b)
    torch.testing.assert_close(out[:, start * 16:], full[:, start * 16:])
    # an empty band: the epilogue of a zero accumulator
    empty = tbsr.bsr_matmul(x, T(v), T(r), b, activation="relu", band=(0, 1, 0))
    torch.testing.assert_close(empty[:, :16], torch.relu(b[:16]).expand(5, 16))
    with pytest.raises(ValueError, match="multiples of 8"):
        tbsr.bsr_matmul(x, T(v[:, :, :, :12].copy()), T(r))
    with pytest.raises(ValueError, match="band"):
        tbsr.bsr_matmul(x, T(v), T(r), band=(0, 5, 1))
    with pytest.raises(ValueError, match="side"):
        tbsr.bsr_matmul(x, T(v), T(r), None, x[:, :8], epilogue=(("add", 0),))
    assert tbsr.launches == 0


# --------------------------------------------------------------------------- #
# the compiler: the pruned MLP graph                                           #
# --------------------------------------------------------------------------- #

#: the JAX test's recipe (test_graph_compiler.test_sparse_substitution_pipeline_exact)
RECIPE = {"l1": ("block", 0.5), "l2": ("column", 0.5), "l3": ("channel", 0.5)}


def _structures(torch_side):
    if torch_side:
        return {"l1": Block(0.5, bm=128, bn=128, balanced=False), "l2": Column(0.5),
                "l3": Channel(0.5)}
    return {"l1": JBlock(0.5, bm=128, bn=128, balanced=False), "l2": JColumn(0.5),
            "l3": JChannel(0.5)}


def _port_graph(jg):
    """The port's copy of a JAX linear-chain graph, on the same arrays."""
    b = GraphBuilder(list(jg.inputs))
    for n in jg.nodes:
        b.add(n.op, n.inputs, name=n.name,
              params={k: torch.tensor(np.asarray(v)) for k, v in jg.params[n.name].items()},
              **n.attrs)
    return b.build(jg.outputs)


@pytest.fixture(scope="module")
def mlp():
    jg = _mlp_graph()
    g = _port_graph(jg)
    jst, st = _structures(False), _structures(True)
    jmasks = {k: jproject(jg.params[k]["w"], s)[1] for k, s in jst.items()}
    masks = {k: project(g.params[k]["w"], s)[1] for k, s in st.items()}
    for k in masks:
        np.testing.assert_array_equal(masks[k].numpy(), np.asarray(jmasks[k]))
    ctx = PassContext(masks=masks, structures=st)
    go = PassManager().run(g, ctx)
    jgo = joptimize(jg, jmasks, jst)
    x = np.random.default_rng(30).standard_normal((8, 256)).astype(np.float32)
    return dict(jg=jg, g=g, go=go, jgo=jgo, ctx=ctx, x=x)


def test_pruned_mlp_graph_equals_jax(mlp):
    go, jgo = mlp["go"], mlp["jgo"]
    view = lambda g: [(n.name, n.op, tuple(n.inputs),  # noqa: E731
                       tuple((k, v) for k, v in sorted(n.attrs.items()) if k != "idx"))
                      for n in g.nodes]
    assert view(go) == view(jgo)
    l1 = next(n for n in go.nodes if n.name == "l1")
    assert l1.attrs["format"] == "pbcsr" and l1.attrs["bn"] == 128
    for name, p in go.params.items():
        jp = jgo.params[name]
        assert sorted(p) == sorted(jp)
        for k, v in p.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
    assert go.params["l1"]["block_rows"].dtype == torch.int32
    for n in go.nodes:
        if n.op == "gather_channels":
            jn = next(m for m in jgo.nodes if m.name == n.name)
            np.testing.assert_array_equal(np.asarray(n.attrs["idx"]), np.asarray(jn.attrs["idx"]))
    assert mlp["ctx"].stats["substitute_sparse"].nodes_after >= len(mlp["g"].nodes)


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_pruned_mlp_plan_matches_jax_plan(mlp, backend):
    go, jgo, x = mlp["go"], mlp["jgo"], mlp["x"]
    want = jcompile_plan(jgo, backend=backend, interpret=backend == "kernel")(jgo.params, J(x))
    got = compile_plan(go, backend=backend, device="cpu")(go.params, T(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # the masked-dense graph computes the same function
    pm = {}
    for k, p in mlp["g"].params.items():
        pm[k] = dict(p)
        if k in RECIPE:
            mask = project(p["w"], _structures(True)[k])[1]
            pm[k]["w"] = p["w"] * mask
            if RECIPE[k][0] == "channel":  # channel pruning removes the bias too
                pm[k]["b"] = p["b"] * torch.any(mask != 0, dim=0)
    dense = compile_plan(mlp["g"], backend="reference", device="cpu")(pm, T(x))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-4, atol=1e-4)


def test_memory_estimate_counts_packed_params(mlp):
    go = mlp["go"]
    plan = compile_plan(go, backend="kernel", device="cpu")
    mem = plan.memory_estimate((8, 256))
    want = sum(v.numel() * v.element_size() for p in go.params.values() for v in p.values())
    assert mem["param_bytes"] == want
    assert mem["param_bytes_by_dtype"]["int32"] >= go.params["l1"]["block_rows"].numel() * 4
