"""``bsr_matmul``'s bf16 route and the dense bf16 decode route on the TMA +
wgmma body (``csrc/wgmma_gemm.cuh``), as far as the CPU reaches them: the
plan of the block-sparse route (``bsr_matmul.plan``), its K walk
(a model of the coordinates ``wgmma_gemm::BsrWalk`` loads, held to the
dense product here and to the CUDA walk by ``chip_smoke.py``'s cases),
the instances against the CUDA sources, and the body's summation order
emulated in torch against the JAX package's Pallas ``bsr_matmul`` /
``dense_matmul`` in interpret mode and against the port's plain versions.
No model is built and no process is started.

Tolerance for bf16 outputs: one bf16 ulp of max|ref| (every side sums in
f32 and rounds once; the order of the sums differs).
"""

import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.pruning import Block as JBlock
from repro.core.pruning import project as jproject
from repro.core.sparse import formats as jformats
from repro.kernels import ops as jops
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import bsr_matmul as tbsr
from repro_torch.kernels import dense_matmul as tdense
from repro_torch.kernels.ref import _ACT, bf16_ulp

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
BF16 = torch.bfloat16


def _bf16(rng, *shape, scale=1.0):
    """A numpy bf16 array (ml_dtypes) and the same values as a torch bf16
    tensor."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32).astype(ml_dtypes.bfloat16)
    return a, torch.from_numpy(a.astype(np.float32)).to(BF16)


def _tma_walk(block_rows, band, m, bm, bn, p):
    """This file's model of the wgmma route's K walk of one band, as
    ``wgmma_gemm::BsrWalk`` walks it on the card, for each CTA ``(y, z)``
    of ``bsr_matmul.tma_grid``'s grid (every M tile walks the same):
    ``(out_col, w_col, slabs)`` -- the first output column of its
    ``p.width`` columns, their first column in a block (the weight map's
    box column), and its slabs in order as ``(x_col, w_row)``: the x
    columns and the rows of ``values`` seen as one ``[Nb * S * bm, bn]``
    matrix that each ``BK``-row slab reads, pads (-1) dropped."""
    start, _, count = band
    s_stride = block_rows.shape[1]
    (_, gy, gz), bk = tbsr.tma_grid(m, bm, bn, band[1] - start, p)
    table = block_rows.tolist()
    walk = {}
    for y in range(gy):
        j = start + y // (bn // p.width)
        w_col = y % (bn // p.width) * p.width
        for z in range(gz):
            steps = range(z * p.schunk, min(count, (z + 1) * p.schunk))
            slabs = [(table[j][t] * bm + u, (j * s_stride + t) * bm + u)
                     for t in steps if table[j][t] >= 0 for u in range(0, bm, bk)]
            walk[(y, z)] = (j * bn + w_col, w_col, slabs)
    return walk


# --------------------------------------------------------------------------- #
# bsr_matmul: the wgmma route's plan                                          #
# --------------------------------------------------------------------------- #

#: (m, bm, bn, ncols, count): the decoder's q / o at prefill, every slab
#: depth, 32-column tiles, long and empty bands, a decode block past the
#: streaming body's stage
TMA_SHAPES = [(48, 64, 64, 32, 16), (3, 2048, 64, 2, 1), (9, 32, 32, 8, 4), (70, 128, 96, 5, 9),
              (200, 256, 64, 3, 40), (12, 32, 64, 1, 0), (48, 64, 64, 1, 2047),
              (48, 96, 32, 2, 2048), (16, 64, 64, 64, 1)]


@pytest.mark.parametrize("shape", TMA_SHAPES, ids=["x".join(map(str, s)) for s in TMA_SHAPES])
def test_bsr_tma_plan_covers_every_step_once_in_a_cluster(shape):
    """Every packed step of a column lands in exactly one split, in order,
    every split non-empty, at most a cluster's 8 splits of at most the
    table's 256 steps; the width divides bn; the plan is a function of
    ``(m, bm, bn, ncols, count)`` alone."""
    m, bm, bn, ncols, count = shape
    p = tbsr.plan(m, bm, bn, ncols, count, True)
    assert p.route == "wgmma"
    assert p.width == (64 if bn % 64 == 0 else 32) and bn % p.width == 0
    assert 1 <= p.nsplit <= tbsr.TMA_MAX_SPLIT == _build.TMA_MAX_CLUSTER
    assert p.schunk <= tbsr.TMA_MAX_STEPS
    covered = [t for z in range(p.nsplit)
               for t in range(z * p.schunk, min(count, (z + 1) * p.schunk))]
    assert covered == list(range(count))
    assert all(z * p.schunk < count for z in range(p.nsplit)) or count == 0
    assert p.tiles == bn // p.width * ncols * -(-m // tbsr.TMA_MT)
    assert tbsr.plan(m, bm, bn, ncols, count, True) == p
    assert list(inspect.signature(tbsr.plan).parameters)[:5] == ["m", "bm", "bn", "ncols",
                                                                  "count"]


def test_bsr_tma_plan_at_the_decoders_prefill():
    """qwen2.5-3b's q / o pruned with Block(0.5, 64, 64) at prefill: 32
    block-columns of 16 steps, 64 x 64 tiles, the split the target gives."""
    p = tbsr.plan(48, 64, 64, 32, 16, True)
    want = min(-(-tbsr.TMA_TARGET // 32), 8)
    assert p == tbsr.BsrPlan("wgmma", 64, -(-16 // -(-16 // want)), -(-16 // want), 32)
    assert tbsr.tma_grid(48, 64, 64, 32, p) == ((1, 32, p.nsplit), 64)


@pytest.mark.parametrize("bm,want", [(32, 32), (64, 64), (96, 32), (128, 128), (192, 64),
                                     (256, 128), (16, 0), (48, 0), (24, 0)])
def test_bsr_tma_slab_rows(bm, want):
    assert tbsr.tma_bk(bm) == want


# --------------------------------------------------------------------------- #
# the K walk                                                                   #
# --------------------------------------------------------------------------- #


def _packed(rng, k, n, bm, bn, density=0.5):
    """A packed weight with pads: ``(values [Nb, S, bm, bn], block_rows
    [Nb, S])`` and the dense weight it stands for (pads' values are 0)."""
    kb, nb = k // bm, n // bn
    keep = rng.random((kb, nb)) < density
    keep[0, :] |= ~keep.any(axis=0)  # no column without a block
    s = int(keep.sum(axis=0).max()) + 1  # a pad in every column
    values = np.zeros((nb, s, bm, bn), np.float32)
    rows = np.full((nb, s), -1, np.int32)
    dense = np.zeros((k, n), np.float32)
    for j in range(nb):
        for i, r in enumerate(np.flatnonzero(keep[:, j])):
            blk = rng.standard_normal((bm, bn)).astype(np.float32) * k ** -0.5
            values[j, i], rows[j, i] = blk, r
            dense[r * bm:(r + 1) * bm, j * bn:(j + 1) * bn] = blk
    return values, rows, dense


@pytest.mark.parametrize("bm,bn,m", [(64, 64, 48), (32, 32, 12), (128, 64, 20), (64, 96, 9)])
def test_k_walk_rebuilds_the_dense_product(bm, bn, m):
    """The K walk's coordinates over a band with pads, an empty band and a
    band cut short (``count`` below S): x columns and packed rows gathered
    slab by slab rebuild the dense weight's product for the band's columns,
    and every live block is read exactly once a column tile."""
    rng = np.random.default_rng(bm + bn + m)
    k, n = 4 * bm, 4 * bn
    values, rows, dense = _packed(rng, k, n, bm, bn)
    nb, s = rows.shape
    x = rng.standard_normal((m, k)).astype(np.float32)
    flat = values.reshape(nb * s * bm, bn)
    got = np.zeros((m, n), np.float32)
    cut = max(s - 2, 0)
    for band in ((0, 1, 0), (1, 3, s), (3, 4, cut)):
        start, stop, count = band
        p = tbsr.plan(m, bm, bn, stop - start, count, True)
        walk = _tma_walk(torch.from_numpy(rows), band, m, bm, bn, p)
        (_, gy, gz), bk = tbsr.tma_grid(m, bm, bn, stop - start, p)
        assert set(walk) == {(y, z) for y in range(gy) for z in range(gz)}
        for (y, z), (out_col, w_col, slabs) in walk.items():
            assert out_col % bn == w_col and w_col + p.width <= bn
            for x_col, w_row in slabs:
                got[:, out_col:out_col + p.width] += (
                    x[:, x_col:x_col + bk] @ flat[w_row:w_row + bk, w_col:w_col + p.width])
        live = int((rows[start:stop, :count] >= 0).sum())
        read = sum(len(sl) for sl in (v[2] for v in walk.values()))
        assert read == live * (bm // bk) * (bn // p.width)
    want = x @ dense
    want[:, 0:bn] = 0.0  # the empty band
    for t in range(cut, s):  # the steps the last band leaves out
        if rows[3, t] >= 0:
            want[:, 3 * bn:] -= x[:, rows[3, t] * bm:(rows[3, t] + 1) * bm] @ values[3, t]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


# --------------------------------------------------------------------------- #
# the instances                                                                #
# --------------------------------------------------------------------------- #


def _macro_pairs(name):
    src = (CSRC / "tiles.cuh").read_text()
    body = src.split(f"#define {name}(X)")[1].split("\n\n")[0]
    return [tuple(int(v) for v in t.split(",")) for t in re.findall(r"X\(([^)]*)\)", body)]


def test_bsr_wgmma_instances_match_the_tile_list():
    """tiles.cuh's block-sparse list is ``_build.BSR_TMA_TILES``: every
    width the plan picks by every slab depth ``tma_bk`` picks, each within
    a block's shared memory with the walk's 256-step table; bsr_matmul.cu
    dispatches over the list on the wgmma body with ``BsrWalk`` and no
    longer holds an ``mma.sync`` body."""
    assert tuple(_macro_pairs("REPRO_BSR_TMA_TILES")) == _build.BSR_TMA_TILES
    assert {(w, bk) for w in (64, 32) for bk in (128, 64, 32)} == set(_build.BSR_TMA_TILES)
    for bn, bk in _build.BSR_TMA_TILES:
        shape = _build.wgmma_shape((64, bn, bk, 1))
        assert shape["smem"] + 256 * 4 <= _build.SMEM_LIMIT
    entry = (CSRC / "bsr_matmul.cu").read_text()
    assert "REPRO_BSR_TMA_TILES(REPRO_TRY_BSR_TMA)" in entry
    assert "wgmma_gemm::BsrWalk walk{rows, s_stride, col0, bm, bn, count, schunk}" in entry
    assert "mma_sync" not in entry and "bsr_matmul_mma_kernel" not in entry
    head = (CSRC / "wgmma_gemm.cuh").read_text()
    assert "static constexpr int TABLE = 256;" in head
    assert tbsr.TMA_MAX_STEPS == 256 and tbsr.ROUTES["wgmma"] == 1


# --------------------------------------------------------------------------- #
# the body's summation order against the JAX package                          #
# --------------------------------------------------------------------------- #


def _emulate_bsr(x, values, rows, bias, sides, activation, epilogue, bands):
    """The wgmma route's arithmetic in torch: each CTA's live steps (pads
    dropped) in order, each slab's k16 steps ascending, summed from +0 in
    f32; the splits added in split order; then bias, activation and the
    step program in f32, rounded once to bf16."""
    m = x.shape[0]
    nb, s_stride, bm, bn = values.shape
    flat = values.reshape(nb * s_stride * bm, bn).float()
    out = torch.empty((m, nb * bn), dtype=BF16)
    for band in bands:
        start, stop, count = band
        p = tbsr.plan(m, bm, bn, stop - start, count, True)
        walk = _tma_walk(rows, band, m, bm, bn, p)
        (_, gy, gz), bk = tbsr.tma_grid(m, bm, bn, stop - start, p)
        for y in range(gy):
            out_col, w_col, _ = walk[(y, 0)]
            acc = None
            for z in range(gz):
                part = torch.zeros(m, p.width)
                for x_col, w_row in walk[(y, z)][2]:
                    for k0 in range(0, bk, 16):
                        part = part + x[:, x_col + k0:x_col + k0 + 16].float() @ flat[
                            w_row + k0:w_row + k0 + 16, w_col:w_col + p.width]
                acc = part if acc is None else acc + part
            cols = slice(out_col, out_col + p.width)
            v = acc + (bias[cols].float() if bias is not None else 0.0)
            v = _ACT[activation](v)
            for kind, slot in epilogue:
                v = v + sides[slot][:, cols].float() if kind == "add" else v * sides[slot][
                    :, cols].float()
            out[:, cols] = v.to(BF16)
    return out


@pytest.mark.parametrize("m,bm,bn", [(48, 64, 64), (9, 32, 32)], ids=["prefill", "m9"])
def test_emulated_bsr_body_matches_jax_pallas(m, bm, bn):
    """Two bands of a packed weight with pads (Block(0.5), unbalanced),
    bias, silu and a residual add: the wgmma route's summation order lands
    within one bf16 ulp of the JAX package's Pallas ``bsr_matmul`` in
    interpret mode and of the port's plain version."""
    rng = np.random.default_rng(m + bm)
    k, n = 4 * bm, 4 * bn
    wj, wt = _bf16(rng, k, n, scale=k ** -0.5)
    _, jmask = jproject(jnp.asarray(wj.astype(np.float32)), JBlock(0.5, bm=bm, bn=bn,
                                                                   balanced=False))
    jf = jformats.PBCSR.from_dense(jnp.asarray(wj), jmask, bm, bn)
    vj, rj = np.array(jf.values), np.array(jf.block_rows)
    assert (rj < 0).any(), "no pad in the packing"
    xj, xt = _bf16(rng, m, k)
    bj, bt = _bf16(rng, n, scale=0.1)
    sj, st = _bf16(rng, m, n)
    nb, s = rj.shape
    bands = ((0, 2, s), (2, nb, s))
    epi = (("add", 0),)
    vt = torch.from_numpy(vj.astype(np.float32)).to(BF16)
    rt = torch.from_numpy(rj)
    got = _emulate_bsr(xt, vt, rt, bt, (st,), "silu", epi, bands)
    want = np.asarray(jops.bsr_matmul(jnp.asarray(xj), jnp.asarray(vj), jnp.asarray(rj),
                                      jnp.asarray(bj), activation="silu", epilogue=epi,
                                      epilogue_sides=(jnp.asarray(sj),), bands=bands,
                                      interpret=True), np.float32)
    tol = bf16_ulp(float(np.abs(want).max()))
    assert np.abs(got.float().numpy() - want).max() <= tol
    plain = torch.empty_like(got)
    for band in bands:
        tbsr.bsr_matmul_plain(xt, vt, rt, bt, st, activation="silu", epilogue=epi, band=band,
                              out=plain)
    assert (got.float() - plain.float()).abs().max().item() <= bf16_ulp(
        plain.float().abs().max().item())


# --------------------------------------------------------------------------- #
# the dense decode route                                                       #
# --------------------------------------------------------------------------- #


def _served_decode_gemms():
    """``(label, m, n, k)`` of the q / k/v / o / down projections of the
    three served decoders at decode (M = 3: three sequences a step)."""
    out = []
    for arch in ("qwen2.5-3b", "granite-3-2b", "phi4-mini-3.8b"):
        c = get_config(arch)
        d, dh, h, g, f = c.d_model, c.resolved_head_dim, c.n_heads, c.n_kv_heads, c.d_ff
        for role, k, n in (("q", d, h * dh), ("kv", d, g * dh), ("o", h * dh, d),
                           ("down", f, d)):
            out.append((f"{arch.split('-')[0]}-{role}", 3, n, k))
    return out


DECODE = _served_decode_gemms()


@pytest.mark.parametrize("label,m,n,k", DECODE, ids=[c[0] for c in DECODE])
def test_served_decode_shapes_take_the_measured_body(label, m, n, k):
    """With no tile named the served k / v projections (N <= 1024) go to
    the TMA + wgmma body and q / o / down to the skinny kernel (the decode
    shapes' measured split, ``TMA_DECODE_MAX_N``); the decode tile is of the
    built list and ``tma_plan`` gives ranges of whole 128-row steps
    covering K, at most a cluster's, from the shape alone: the decode
    target's for the k / v shapes, the prefill rule's for a tile named at
    the others."""
    want = "wgmma" if label.endswith("-kv") else "skinny"
    assert _build.bf16_body(m, n, k) == want
    assert (n <= _build.TMA_DECODE_MAX_N) == (want == "wgmma")
    tile, target = _build.TMA_DECODE_TILE, _build.TMA_DECODE_TARGET
    if want == "skinny":  # only a named tile runs the body: the prefill rule's ranges
        tile, target = _build.bf16_default_tile(m, n), _build.TMA_SPLIT_TARGET
    kchunk, nsplit = _build.tma_plan(m, n, k)
    assert tile in _build.BF16_GEMM_TILES and tile[3] == 1
    assert kchunk % _build.TMA_SPLIT_ALIGN == 0
    assert (nsplit - 1) * kchunk < k <= nsplit * kchunk
    assert 1 <= nsplit <= _build.TMA_MAX_CLUSTER
    assert -(-n // tile[1]) * nsplit <= max(target, -(-n // tile[1]))
    assert list(inspect.signature(_build.tma_plan).parameters) == ["m", "n", "k"]


def _emulate_dense(x, w, bias, sides, epilogue):
    """The wgmma body's arithmetic at decode: the plan's K ranges, each
    summed in ascending k16 steps from +0 in f32, the ranges added in split
    order, bias and the step program in f32, one rounding to bf16."""
    m, k = x.shape
    kchunk, nsplit = _build.tma_plan(m, w.shape[1], k)
    acc = None
    for r in range(nsplit):
        part = torch.zeros(m, w.shape[1])
        for k0 in range(r * kchunk, min(k, (r + 1) * kchunk), 16):
            part = part + x[:, k0:k0 + 16].float() @ w[k0:k0 + 16].float()
        acc = part if acc is None else acc + part
    v = acc + (bias.float() if bias is not None else 0.0)
    for kind, slot in epilogue:
        v = v + sides[slot].float()
    return v.to(BF16)


def test_emulated_decode_body_matches_jax_pallas_dense_matmul():
    """At M=3 K=1024 N=256 bf16 with a bias and a residual add (a k / v
    shape, several K ranges of the decode plan) the body's summation order
    lands within one
    bf16 ulp of the JAX package's Pallas ``dense_matmul`` in interpret mode
    and of the port's plain version, which the CPU wrapper returns."""
    m, k, n = 3, 1024, 256
    assert _build.tma_plan(m, n, k)[1] > 1
    rng = np.random.default_rng(35)
    (xj, xt), (wj, wt) = _bf16(rng, m, k), _bf16(rng, k, n, scale=k ** -0.5)
    (bj, bt), (sj, st) = _bf16(rng, n, scale=0.1), _bf16(rng, m, n)
    epi = (("add", 0),)
    got = _emulate_dense(xt, wt, bt, (st,), epi)
    want = np.asarray(jops.matmul(jnp.asarray(xj), jnp.asarray(wj), jnp.asarray(bj),
                                  epilogue=epi, epilogue_sides=(jnp.asarray(sj),),
                                  interpret=True), np.float32)
    tol = bf16_ulp(float(np.abs(want).max()))
    assert np.abs(got.float().numpy() - want).max() <= tol
    plain = tdense.dense_matmul_plain(xt, wt, bt, st, epilogue=epi)
    assert (got.float() - plain.float()).abs().max().item() <= bf16_ulp(
        plain.float().abs().max().item())
    assert torch.equal(tdense.dense_matmul(xt, wt, bt, st, epilogue=epi), plain)


def test_bsr_route_launches_count_nothing_on_cpu_and_reset():
    """``route_launches`` names the three bodies, counts no CPU call (the
    plain version) and is reset with the other launch counts."""
    from repro_torch.kernels import ops as tops

    tbsr.route_launches["wgmma"] += 2
    tops.reset_kernel_launches()
    v = torch.zeros(2, 1, 32, 32, dtype=BF16)
    r = torch.zeros(2, 1, dtype=torch.int32)
    tbsr.bsr_matmul(torch.zeros(48, 32, dtype=BF16), v, r)
    assert set(tbsr.route_launches) == set(tbsr.ROUTES)
    assert not any(tbsr.route_launches.values()) and tbsr.launches == 0
