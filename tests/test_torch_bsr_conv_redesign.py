"""The redesigned block-sparse and conv kernels' host side, on the CPU.

The CUDA bodies run only on the card (``chip_smoke.py``); what they depend
on is plain Python and is held here:

* ``bsr_matmul.plan``: each (M, bm, bn, count, element type, alignment)
  lands on its documented route -- ``stream`` (bf16, M <= 8), ``wgmma``
  (other bf16, bm % 32 == 0, bn % 32 == 0), ``cuda_core`` (the rest) --
  and every split covers each packed step exactly once within the route's
  limits (the C entry's own checks);
* the rows per CTA that the ops layer records for a ``bsr_matmul`` tuning
  key follow the route;
* the conv tile table of ``csrc/tiles.cuh`` mirrors ``_build.CONV_TILES``,
  every tile satisfies the f32 / W8 body's layout constraints
  (``ConvShape``'s static asserts, its shared memory), and every default
  tile is in the list;
* ``bsr_matmul_plain`` and ``conv2d_plain`` against the JAX package at the
  new routes' edge shapes: bm = 16 blocks, a ragged M just past the
  streaming route, pads and bands; a 7x7 conv on 3 gathered channels, a
  ragged stride-2 conv, the W8 scheme.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pruning import Block as JBlock
from repro.core.pruning import project as jproject
from repro.core.sparse import formats as jformats
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import bsr_matmul as tbsr
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ops import TuneEntry, TuningCache
from repro_torch.obs import metrics as tmetrics
from repro_torch.quant import QTensor

ROOT = Path(__file__).resolve().parents[1]
T = torch.from_numpy
J = jnp.asarray
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _port_registry():
    snap = tmetrics.registry().dump_state()
    tops.reset_kernel_launches()
    try:
        yield
    finally:
        tmetrics.registry().load_state(snap)


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# --------------------------------------------------------------------------- #
# bsr_matmul: routes and splits                                                #
# --------------------------------------------------------------------------- #

#: (m, bm, bn, ncols, count, bf16, aligned) -> route
ROUTE_CASES = [
    ((3, 64, 64, 32, 16, True, True), "stream"),  # the decoder's q / o at decode
    ((1, 16, 16, 16, 32, True, True), "stream"),
    ((8, 8, 24, 4, 4, True, True), "stream"),  # M = 8: the last streaming row count
    ((8, 1024, 64, 2, 1, True, True), "stream"),  # the largest block the x stage holds
    ((3, 2048, 40, 2, 1, True, True), "cuda_core"),  # a block past the x stage
    ((3, 2048, 64, 2, 1, True, True), "wgmma"),  # ... that the wgmma body takes
    ((48, 64, 64, 32, 16, True, True), "wgmma"),  # the decoder's prefill
    ((9, 32, 32, 16, 16, True, True), "wgmma"),  # M = 9: past the streaming rows
    ((70, 32, 96, 8, 8, True, True), "wgmma"),  # 32-column tiles
    ((13, 16, 32, 4, 4, True, True), "cuda_core"),  # bm = 16 past M = 8
    ((48, 8, 8, 32, 16, True, True), "cuda_core"),  # bm % 32 != 0
    ((48, 24, 16, 4, 4, True, True), "cuda_core"),
    ((100, 32, 32, 4, 3000, True, True), "cuda_core"),  # more steps than 8 x 256
    ((48, 64, 64, 32, 16, True, False), "cuda_core"),  # an unaligned operand
    ((3, 64, 64, 32, 16, True, False), "cuda_core"),
    ((3, 64, 64, 32, 16, False, True), "cuda_core"),  # f32 stays true f32
    ((48, 64, 64, 32, 16, False, True), "cuda_core"),
]


@pytest.mark.parametrize("case,route", ROUTE_CASES, ids=[
    "x".join(map(str, c[:5])) + ("-bf16" if c[5] else "-f32") + ("" if c[6] else "-unaligned")
    for c, _ in ROUTE_CASES])
def test_bsr_route_is_the_documented_one(case, route):
    assert tbsr.plan(*case).route == route


def _check_split(p, count, bm):
    """The split covers steps [0, count) once, every split non-empty, in
    the form the C entry accepts (schunk = ceil(count / nsplit))."""
    if count == 0:
        assert p.nsplit == 1
        return
    assert p.schunk == -(-count // p.nsplit)
    assert -(-count // p.schunk) == p.nsplit
    covered = []
    for i in range(p.nsplit):
        steps = list(range(i * p.schunk, min(count, (i + 1) * p.schunk)))
        assert steps, f"split {i} of {p} is empty"
        covered += steps
    assert covered == list(range(count))
    if p.route == "stream":
        assert p.schunk * bm <= tbsr.STREAM_KC
    if p.route == "wgmma":
        assert p.nsplit <= tbsr.TMA_MAX_SPLIT and p.schunk <= tbsr.TMA_MAX_STEPS
    assert p.nsplit <= 65535


SPLIT_SHAPES = [(m, bm, bn, ncols, count)
                for m in (1, 3, 8, 9, 48, 200)
                for bm, bn in ((8, 8), (16, 32), (64, 64), (128, 24))
                for ncols, count in ((1, 0), (1, 1), (3, 7), (32, 16), (4, 300))]


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("m", [1, 3, 8, 9, 48, 200])
def test_bsr_splits_cover_every_step_once(m, bf16):
    for _, bm, bn, ncols, count in (s for s in SPLIT_SHAPES if s[0] == m):
        for vec in (1, 2, 4):
            p = tbsr.plan(m, bm, bn, ncols, count, bf16, True, vec)
            _check_split(p, count, bm)
            width = {"stream": tbsr.STREAM_CW, "wgmma": p.width,
                     "cuda_core": 32 * vec}[p.route]
            rows = {"stream": 1, "wgmma": -(-m // tbsr.TMA_MT),
                    "cuda_core": -(-m // tbsr.FMA_MT)}[p.route]
            assert p.tiles == -(-bn // width) * ncols * rows


def test_bsr_plans_at_the_decoders_shapes():
    """qwen2.5-3b's q / o pruned with Block(0.5, 64, 64): 32 block-columns
    of 16 steps.  Decode streams 16 columns a CTA over all 16 steps (128
    CTAs, no split); prefill runs the wgmma body, 64 x 64 tiles in 4 splits
    of 4 steps (128 CTAs, clusters of 4)."""
    assert tbsr.plan(3, 64, 64, 32, 16, True) == tbsr.BsrPlan("stream", 16, 1, 16, 128)
    assert tbsr.plan(48, 64, 64, 32, 16, True) == tbsr.BsrPlan("wgmma", 64, 4, 4, 32)


def test_bsr_split_is_fixed_by_the_shape():
    """Neither the data nor the call order moves a plan: the same shape
    gives the same plan, on operands that are aligned."""
    x = torch.zeros(48, 256, dtype=BF16)
    v = torch.zeros(4, 4, 64, 64, dtype=BF16)
    assert tbsr.plan_for(x, v, 4, 4) == tbsr.plan(48, 64, 64, 4, 4, True)
    assert tbsr.plan_for(x[:3], v, 4, 4) == tbsr.plan(3, 64, 64, 4, 4, True)


@pytest.fixture
def fresh_cache():
    cache = tops.tuning_cache()
    state = (cache.enabled, dict(cache.entries), cache.sweeps, dict(cache.stats),
             cache.ops_filter)
    cache.clear()
    cache.enabled = False
    cache.ops_filter = None
    yield cache
    (cache.enabled, cache.entries, cache.sweeps, cache.stats, cache.ops_filter) = state


def test_bsr_tuning_record_follows_the_route(fresh_cache):
    """``ops.bsr_matmul`` records the rows a CTA covers for the shape: 64
    on the wgmma route (bf16, M > 8, 32 x 32 blocks), 8 elsewhere (f32,
    decode, or bf16 blocks the route does not take); a loaded entry naming
    the other raises."""
    rng = np.random.default_rng(3)
    v = T(_arr(rng, 2, 2, 32, 32)).to(BF16)
    r = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    tops.bsr_matmul(T(_arr(rng, 48, 64)).to(BF16), v, r)
    tops.bsr_matmul(T(_arr(rng, 3, 64)).to(BF16), v[:, :, :16, :16].contiguous(), r)
    tops.bsr_matmul(T(_arr(rng, 48, 64)), v.float(), r)
    assert fresh_cache.entries == {
        TuningCache.key("bsr_matmul", 48, 64, 64, BF16, "pbcsr", "cpu"): TuneEntry((64,), "default"),
        TuningCache.key("bsr_matmul", 3, 32, 64, BF16, "pbcsr", "cpu"): TuneEntry((8,), "default"),
        TuningCache.key("bsr_matmul", 48, 64, 64, torch.float32, "pbcsr", "cpu"):
            TuneEntry((8,), "default"),
    }
    assert TuningCache.CANDIDATES["bsr_matmul"] == ((8,), (64,))
    fresh_cache.entries[TuningCache.key("bsr_matmul", 48, 64, 64, BF16, "pbcsr", "cpu")] = \
        TuneEntry((8,), "loaded")
    with pytest.raises(_build.TileError, match=r"\(64,\)"):
        tops.bsr_matmul(T(_arr(rng, 48, 64)).to(BF16), v, r)


# --------------------------------------------------------------------------- #
# conv2d: the tile table                                                       #
# --------------------------------------------------------------------------- #


def _conv_tiles():
    src = (ROOT / "src/repro_torch/kernels/csrc/tiles.cuh").read_text()
    body = src.split("#define REPRO_CONV_TILES(X)")[1].split("\n\n")[0]
    return [tuple(int(v) for v in t.split(",")) for t in re.findall(r"X\(([^)]*)\)", body)]


def test_conv_tile_table_mirrors_build_and_keeps_six_tiles():
    tiles = _conv_tiles()
    assert tuple(t[:3] for t in tiles) == _build.CONV_TILES
    assert len(tiles) >= 6


@pytest.mark.parametrize("tile", _conv_tiles(), ids=lambda t: "x".join(map(str, t)))
def test_conv_tile_fits_the_f32_body(tile):
    """csrc/conv2d.cu ConvShape's constraints, checked before a build: 4-wide
    float4 groups, whole warps of 8 x 4 (or 32 x 1) threads, whole pixels
    and k rows a gathering thread, static shared memory under 48 KB."""
    bm, bn, bk, tm, tn = tile
    assert tm in (4, 8) and tn in (4, 8) and bm % tm == 0 and bn % tn == 0
    tx, ty = bm // tm, bn // tn
    nt = tx * ty
    ly = min(ty, 4)
    lx = 32 // ly
    assert tx % lx == 0 and ty % ly == 0 and nt % 32 == 0 and nt <= 1024
    assert bm % nt == 0 or nt % bm == 0
    kt = nt // bm if nt > bm else 1
    assert bk % kt == 0
    smem = 2 * bk * bm * 4 + 2 * bk * (bn + 4) * 4 + 2 * bk * 16
    assert smem <= 48 * 1024
    # the W8A8 body (int8 tensor cores) derives its own tile from the tuple;
    # tests/test_torch_flash_w8a8_redesign.py checks its constraints
    sh = _build.conv_w8a8_shape(tile)
    assert sh["bm"] == bm and sh["bk"] % 32 == 0 and sh["bn"] % 8 == 0
    assert sh["threads"] <= 1024


@pytest.mark.parametrize("scheme", ["f32", "w8", "w8a8"])
def test_conv_default_tiles_are_in_the_table(scheme):
    for o in (1, 2, 3, 4, 5, 12, 16, 17, 32, 33, 40, 64, 128, 256):
        assert _build.conv_default_tile(scheme, o) in _build.CONV_TILES


@pytest.mark.parametrize("scheme", ["f32", "w8"])
def test_conv_extents_past_32_bit_offsets_raise(scheme):
    """The f32 / W8 body indexes in 32 bits: an operand of 2^31 elements or
    more (or K * kh * kw past 2^32, its k split) is refused before a
    launch, naming the shapes; W8A8 is not."""
    tconv.check_extents(scheme, (4, 192, 256, 256), (32, 96, 3, 3), (4, 32, 256, 256))
    with pytest.raises(ValueError, match=r"x\(1, 1, 65536, 32768\).*2\^31"):
        tconv.check_extents(scheme, (1, 1, 65536, 32768), (1, 1, 3, 3), (1, 1, 65536, 32768))
    with pytest.raises(ValueError, match=r"2\^31"):
        tconv.check_extents(scheme, (1, 1, 8, 8), (65536, 32768, 1, 1), (1, 65536, 8, 8))
    with pytest.raises(ValueError, match=r"2\^31"):  # K * kh * kw past 2^32
        tconv.check_extents(scheme, (1, 60_000_000, 3, 3), (1, 60_000_000, 3, 3), (1, 1, 1, 1))
    tconv.check_extents("w8a8", (1, 1, 65536, 32768), (1, 1, 3, 3), (1, 1, 65536, 32768))


# --------------------------------------------------------------------------- #
# the plain versions against the JAX package at the routes' edge shapes       #
# --------------------------------------------------------------------------- #

#: (m, k, n, bm, bn, balanced)
BSR_EDGE = [(9, 64, 96, 16, 32, False), (13, 192, 96, 16, 32, False), (8, 64, 48, 16, 16, True),
            (3, 128, 64, 64, 64, True), (48, 128, 128, 64, 64, True)]


@pytest.mark.parametrize("case", BSR_EDGE, ids=["x".join(map(str, c[:5])) for c in BSR_EDGE])
def test_bsr_plain_matches_jax_at_route_edges(case):
    m, k, n, bm, bn, balanced = case
    rng = np.random.default_rng(sum(case[:5]))
    w = _arr(rng, k, n, scale=k ** -0.5)
    _, jmask = jproject(J(w), JBlock(0.5, bm=bm, bn=bn, balanced=balanced))
    jf = jformats.PBCSR.from_dense(J(w), jmask, bm, bn)
    v, r = np.array(jf.values), np.array(jf.block_rows)
    x, b = _arr(rng, m, k), _arr(rng, n, scale=0.1)
    want = jref.bsr_matmul_ref(J(x), J(v), J(r), J(b), activation="silu")
    got = tbsr.bsr_matmul_plain(T(x), T(v), T(r), T(b), activation="silu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # one band a call, as the ops layer runs them, through the wrapper
    nb, s = r.shape
    out = torch.empty((m, n))
    for band in ((0, nb // 2, s), (nb // 2, nb, s)):
        tbsr.bsr_matmul(T(x), T(v), T(r), T(b), activation="silu", band=band, out=out)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert tbsr.launches == 0  # the plain version on the CPU


#: (n, c_in, h, w, o, k, stride, kept, act)
CONV_EDGE = [(2, 5, 13, 11, 4, 7, 1, (0, 2, 4), "relu"),  # 7x7 on 3 gathered channels
             (1, 3, 16, 16, 32, 7, 1, None, None),  # the apps' first layer, narrow
             (2, 6, 11, 9, 5, 3, 2, (1, 2, 5), "tanh"),  # ragged stride-2 gather
             (1, 4, 9, 9, 2, 3, 1, None, None)]  # a narrow head (O = 2)


@pytest.mark.parametrize("case", CONV_EDGE, ids=["7x7-kept3", "7x7-3to32", "3x3-s2-kept",
                                                 "3x3-o2"])
def test_conv_plain_matches_jax_at_edges(case):
    n, c_in, h, wd, o, k, stride, kept, act = case
    rng = np.random.default_rng(len(CONV_EDGE) + CONV_EDGE.index(case))
    x = _arr(rng, n, c_in, h, wd)
    c = len(kept) if kept else c_in
    w, b = _arr(rng, o, c, k, k, scale=(c * k * k) ** -0.5), _arr(rng, o, scale=0.1)
    kj = None if kept is None else np.array(kept, np.int32)
    want = jops.conv2d(J(x), J(w), J(b), stride=stride, kept=None if kj is None else J(kj),
                       activation=act, interpret=True)
    got = tconv.conv2d_plain(T(x), T(w), T(b), stride=stride,
                             kept=None if kj is None else T(kj), activation=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_conv_w8_plain_matches_the_dequantized_jax_reference():
    """W8: f32 activations against the int8 filter widened as it is staged
    and rescaled per output channel after the sum."""
    rng = np.random.default_rng(11)
    x, w, b = _arr(rng, 2, 6, 12, 10), _arr(rng, 8, 4, 3, 3, scale=0.3), _arr(rng, 8, scale=0.1)
    kept = np.array([0, 1, 3, 5], np.int32)
    qt = QTensor.from_float(T(w), axis=0)
    got = tconv.conv2d_plain(T(x), qt.values, T(b), ws=qt.scale, kept=T(kept), stride=2,
                             activation="relu")
    wdq = qt.values.numpy().astype(np.float32) * qt.scale.numpy()[:, None, None, None]
    want = jref.conv2d_ref(J(x[:, kept]), J(wdq), J(b), stride=2, activation="relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
