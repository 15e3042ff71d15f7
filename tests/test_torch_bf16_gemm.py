"""The bf16 GEMM routes of the port (the tensor-core kernel of
``csrc/mma_gemm.cuh`` behind ``dense_matmul`` / ``dense_matmul_pipelined``
/ ``ffn_gateup``, and the weight-streaming kernel of
``csrc/skinny_bf16.cuh`` at decode), as far as the CPU reaches them: their
tile list against the CUDA sources, the shape-fixed K split and the skinny
plan the wrappers hand the kernels, the tuning candidates by element type,
and the wrappers' CPU route (the plain versions) against the JAX package.

Tolerance for bf16 outputs: one bf16 ulp of max|ref| (both sides sum in
f32 and round once; the order differs).
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import dense_matmul as tdense
from repro_torch.kernels import dense_matmul_pipelined as tdense_pipe
from repro_torch.kernels import fused_ffn as tffn
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ops import TuningCache

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
#: an H100's SMs: the default bf16 tile and K split must give the decoder's
#: M = 48 prefill GEMMs about one block per SM
SMS = 132
#: qwen2.5-3b's projections: (name, N, K) -- q / o 2048 -> 2048, k / v
#: 2048 -> 256, down 11008 -> 2048, gate / up 2048 -> 11008 (two weights)
DECODER_GEMMS = [("q_o", 2048, 2048), ("k_v", 256, 2048), ("down", 2048, 11008),
                 ("gate_up", 11008, 2048)]


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bf16_pair(a):
    b = a.astype(ml_dtypes.bfloat16)
    return jnp.asarray(b), torch.from_numpy(b.astype(np.float32)).to(BF16)


def _ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


def _close_bf16(got, want):
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    w = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    assert np.max(np.abs(g - w)) <= _ulp(float(np.max(np.abs(w)))), np.max(np.abs(g - w))


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


# --------------------------------------------------------------------------- #
# the tile list                                                                #
# --------------------------------------------------------------------------- #


def _macro_tiles(name):
    src = (ROOT / "src/repro_torch/kernels/csrc/tiles.cuh").read_text()
    body = src.split(f"#define {name}(X)")[1].split("\n\n")[0]
    return [tuple(int(v) for v in t.split(",")) for t in re.findall(r"X\(([^)]*)\)", body)]


def test_bf16_tile_table_matches_the_cuda_sources():
    tiled = _macro_tiles("REPRO_BF16_TILED_TILES")
    piped = _macro_tiles("REPRO_BF16_PIPELINED_TILES")
    assert {t[3] for t in tiled} == {1} and {t[3] for t in piped} == {2, 3}
    assert tuple(tiled + piped) == _build.BF16_GEMM_TILES
    # whole 32 x 32 warp tiles, whole k16 steps (csrc/mma_gemm.cuh's Tile)
    assert all(bm % 32 == 0 and bn % 32 == 0 and bk % 16 == 0
               for bm, bn, bk, _ in _build.BF16_GEMM_TILES)
    assert not set(_build.BF16_GEMM_TILES) & set(_build.GEMM_TILES)


@pytest.mark.parametrize("m,n", [(1, 8), (48, 256), (48, 257), (48, 11008), (64, 2048),
                                 (65, 32), (1000, 4096)])
def test_bf16_default_tile_is_built_at_every_depth(m, n):
    tile = _build.bf16_default_tile(m, n)
    assert tile[3] == 1
    assert _build.default_gemm_tile(m, n, BF16) == tile
    assert _build.default_gemm_tile(m, n, torch.float32) == _build.gemm_default_tile(n)
    for depth in (1, 2, 3):
        assert (*tile[:3], depth) in _build.BF16_GEMM_TILES


def test_gemm_tiles_are_checked_against_the_element_types_list():
    assert _build.check_gemm_tile([64, 64, 64, 2], dtype=BF16) == (64, 64, 64, 2)
    with pytest.raises(_build.TileError, match="bf16 GEMM kernels"):
        _build.check_gemm_tile((64, 64, 16, 1), "pin", BF16)
    with pytest.raises(_build.TileError, match="the GEMM kernels"):
        _build.check_gemm_tile((64, 64, 64, 1), "pin", torch.float32)


# --------------------------------------------------------------------------- #
# the K split and the skinny plan                                              #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name,n,k", DECODER_GEMMS, ids=[g[0] for g in DECODER_GEMMS])
def test_decoder_prefill_gemms_fill_the_card(name, n, k):
    """At the M = 48 prefill (3 prompts of 16 tokens) the default tile and the
    shape's K split give at least ~one block per SM (128 of 132), and no
    K range is so long that one block walks most of K alone."""
    m = 48
    bm, bn, _, _ = _build.bf16_default_tile(m, n)
    kchunk, nsplit = _build.gemm_split(m, n, k)
    blocks = -(-m // bm) * -(-n // bn) * nsplit
    assert blocks >= 0.95 * SMS, (blocks, kchunk, nsplit)
    assert kchunk <= max(_build.SPLIT_MAX_K, -(-k // 64) * 64)


@pytest.mark.parametrize("m,n,k", [(48, 2048, 2048), (48, 256, 2048), (48, 2048, 11008),
                                   (48, 11008, 2048), (20, 51, 71), (20, 77, 130),
                                   (9, 32, 64), (1000, 70, 50), (64, 4096, 100000), (48, 8, 0)])
def test_gemm_split_ranges_cover_k_in_whole_k16_steps(m, n, k):
    """The ranges depend on the shape alone (the function takes no tile), are
    whole 64-row multiples (so whole k16 steps and whole BK = 32 / 64 slabs
    of every tile), cover K exactly, and each holds at least SPLIT_MIN_K
    rows unless there is one range."""
    kchunk, nsplit = _build.gemm_split(m, n, k)
    if k == 0:
        assert (kchunk, nsplit) == (1, 1)
        return
    assert kchunk % _build.SPLIT_ALIGN == 0
    assert (nsplit - 1) * kchunk < k <= nsplit * kchunk
    assert nsplit == 1 or kchunk >= _build.SPLIT_MIN_K
    assert nsplit <= 65535


def test_gemm_split_of_the_decoder_shapes():
    assert _build.gemm_split(48, 2048, 2048) == (448, 5)
    assert _build.gemm_split(48, 256, 2048) == (128, 16)
    assert _build.gemm_split(48, 2048, 11008) == (1408, 8)
    assert _build.gemm_split(48, 11008, 2048) == (2048, 1)  # 172 tiles: no split


#: (m, n, k, vec) -> (kchunk, nsplit, column tiles): the decoder's decode
#: projections at batch 3 and ragged shapes
SKINNY = {
    (3, 2048, 2048, 8): (256, 8, 32),
    (3, 256, 2048, 8): (128, 16, 4),
    (3, 2048, 11008, 8): (1024, 11, 32),
    (3, 11008, 2048, 8): (1024, 2, 172),
    (1, 2048, 2048, 8): (256, 8, 32),
    (8, 2048, 2048, 8): (256, 8, 32),
    (5, 50, 70, 1): (96, 1, 7),
    (8, 32, 64, 8): (64, 1, 1),
    (4, 96, 5000, 8): (160, 32, 2),
}


@pytest.mark.parametrize("shape", list(SKINNY), ids=["x".join(map(str, s)) for s in SKINNY])
def test_skinny_plan(shape):
    """The bf16 skinny plan: 8 * vec columns a block, K in a few long ranges
    (whole 32-row block steps, at most SKINNY_KC, at least SKINNY_MIN_K
    unless one range), no more ranges than about two blocks per SM need
    unless K is too long for SKINNY_KC."""
    m, n, k, vec = shape
    kchunk, nsplit, tiles = _build.skinny_plan(m, n, k, vec)
    assert (kchunk, nsplit, tiles) == SKINNY[shape]
    assert tiles == -(-n // (8 * vec))
    assert kchunk % 32 == 0 and kchunk <= _build.SKINNY_KC
    assert (nsplit - 1) * kchunk < k <= nsplit * kchunk
    assert nsplit == 1 or kchunk >= _build.SKINNY_MIN_K
    assert tiles * (nsplit - 1) < _build.SKINNY_TARGET_BLOCKS or kchunk == _build.SKINNY_KC


@pytest.mark.parametrize("shape,want", [((3, 256, 128, 4), (64, 2, 2)),
                                        ((3, 11008, 2048, 4), (512, 4, 86)),
                                        ((5, 50, 70, 1), (35, 2, 2))])
def test_skinny_plan_f32_is_the_gate_up_decode_plan_it_was(shape, want):
    """The f32 gate/up route keeps its kernel and its plan bit for bit."""
    assert _build.skinny_plan_f32(*shape) == want


# --------------------------------------------------------------------------- #
# tuning candidates by element type                                            #
# --------------------------------------------------------------------------- #


def test_tuning_candidates_by_dtype():
    assert TuningCache.candidates("matmul", BF16) == _build.BF16_GEMM_TILES
    assert TuningCache.candidates("matmul", jnp.dtype("bfloat16")) == _build.BF16_GEMM_TILES
    assert TuningCache.candidates("matmul", torch.float32) == _build.GEMM_TILES
    assert TuningCache.candidates("qmatmul", torch.int8) == _build.GEMM_TILES
    assert TuningCache.candidates("conv2d", torch.float32) == _build.CONV_TILES


def test_bf16_sweep_times_the_bf16_tiles_under_the_same_key(fresh_cache, tmp_path):
    rng = np.random.default_rng(31)
    x = torch.from_numpy(_arr(rng, 40, 24)).to(BF16)
    w = torch.from_numpy(_arr(rng, 24, 16)).to(BF16)
    fresh_cache.enabled = True
    tried = []
    real = tops._dense_call

    def spy(x2, w_, bias, sides2, act, epi, tile):
        out = real(x2, w_, bias, sides2, act, epi, tile)
        tried.append(tile)
        return out

    try:
        tops._dense_call = spy
        got = tops.matmul(x, w)
    finally:
        tops._dense_call = real
    assert torch.equal(got, tdense.dense_matmul_plain(x, w))
    key = TuningCache.key("matmul", 40, 16, 24, BF16, "dense", "cpu")
    assert key == "matmul|40x16x24|bfloat16|dense|cpu"
    e = fresh_cache.entries[key]
    assert e.source == "swept" and e.blocks in _build.BF16_GEMM_TILES
    assert set(tried[:-1]) == set(_build.BF16_GEMM_TILES)
    path = fresh_cache.save(str(tmp_path / "t.json"))
    loaded = TuningCache(enabled=False).load(path)
    assert loaded.entries[key].blocks == e.blocks


def test_bf16_matmul_records_the_default_bf16_tile(fresh_cache):
    rng = np.random.default_rng(32)
    x = torch.from_numpy(_arr(rng, 48, 64)).to(BF16)
    w = torch.from_numpy(_arr(rng, 64, 300)).to(BF16)
    tops.matmul(x, w)
    (key, entry), = fresh_cache.entries.items()
    assert key == TuningCache.key("matmul", 48, 300, 64, BF16, "dense", "cpu")
    assert entry.blocks == _build.bf16_default_tile(48, 300) == (64, 64, 64, 1)
    # a loaded f32 tile for a bf16 key names a tile the bf16 kernel lacks
    entry.blocks = (64, 64, 16, 1)
    with pytest.raises(_build.TileError, match=re.escape(key)):
        tops.matmul(x, w)


# --------------------------------------------------------------------------- #
# the wrappers' CPU route                                                      #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("tile", _build.BF16_GEMM_TILES,
                         ids=["x".join(map(str, t)) for t in _build.BF16_GEMM_TILES])
def test_bf16_tiles_run_the_plain_version_on_cpu_and_match_jax(tile):
    rng = np.random.default_rng(33)
    (xj, xt), (wj, wt), (bj, bt), (sj, st) = (
        _bf16_pair(_arr(rng, 20, 71)), _bf16_pair(_arr(rng, 71, 51, scale=71 ** -0.5)),
        _bf16_pair(_arr(rng, 51, scale=0.1)), _bf16_pair(_arr(rng, 20, 51)),
    )
    epi = (("add", 0),)
    pins = dict(block_m=tile[0], block_n=tile[1], block_k=tile[2])
    if tile[3] == 1:
        got = tdense.dense_matmul(xt, wt, bt, st, epilogue=epi, **pins)
    else:
        got = tdense_pipe.dense_matmul_pipelined(xt, wt, bt, st, epilogue=epi, depth=tile[3],
                                                 **pins)
    assert got.dtype == BF16
    assert torch.equal(got, tdense.dense_matmul_plain(xt, wt, bt, st, epilogue=epi))
    want = jref.apply_steps_ref(
        jref.matmul_ref(xj, wj, bj, out_dtype=jnp.float32), epi, [sj.astype(jnp.float32)])
    _close_bf16(got, want.astype(jnp.bfloat16))
    assert sum(tops.kernel_launch_counts().values()) == 0


@pytest.mark.parametrize("m", [3, 48])
def test_decoder_shaped_bf16_calls_match_jax_on_cpu(m):
    """Both decoder routes' shapes (M = 3 decode, M = 48 prefill) at narrow
    widths: ``ops.matmul`` and ``ops.ffn_gateup`` against the JAX
    package's wrappers."""
    rng = np.random.default_rng(34 + m)
    (xj, xt), (wj, wt), (bj, bt) = (
        _bf16_pair(_arr(rng, m, 128)), _bf16_pair(_arr(rng, 128, 96, scale=128 ** -0.5)),
        _bf16_pair(_arr(rng, 96, scale=0.1)),
    )
    _close_bf16(tops.matmul(xt, wt, bt), jops.matmul(xj, wj, bj))
    (gj, gt), (uj, ut) = (_bf16_pair(_arr(rng, 128, 64, scale=0.125)),
                          _bf16_pair(_arr(rng, 128, 64, scale=0.125)))
    got = tffn.ffn_gateup(xt, gt, ut, activation="silu")
    assert torch.equal(got, tffn.ffn_gateup_plain(xt, gt, ut, activation="silu"))
    _close_bf16(got, jops.ffn_gateup(xj, gj, uj, activation="silu"))


def test_pipelined_bf16_refuses_depth_one_and_f32_tiles():
    x, w = torch.zeros(20, 16, dtype=BF16), torch.zeros(16, 8, dtype=BF16)
    with pytest.raises(_build.TileError, match="tiled kernel"):
        tdense_pipe.dense_matmul_pipelined(x, w, depth=1)
    with pytest.raises(_build.TileError):
        tdense_pipe.dense_matmul_pipelined(x, w, block_m=64, block_n=64, block_k=16, depth=2)
    assert tdense_pipe.dense_matmul_pipelined(x, w, depth=3).dtype == BF16
