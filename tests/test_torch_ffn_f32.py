"""The f32 gate/up FFN of the port (``csrc/ffn_f32.cuh`` behind
``kernels.fused_ffn.ffn_gateup``) as far as the CPU reaches it: the plans
the wrapper hands its two bodies -- the two-weight GEMM at M > 8
(``_build.ffn_tile_f32`` / ``ffn_split_f32``) and the weight-streaming
kernel at M <= 8 (``_build.skinny_plan_f32``) --, the constants they share
with the CUDA source, and the wrapper's CPU route (the plain version)
against the JAX package at shapes whose K the splits cut raggedly.

Tolerance: 1e-5 (rtol and atol) in f32, where only the summation order
differs.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import fused_ffn as tffn
from repro_torch.kernels import ops as tops

TOL = dict(rtol=1e-5, atol=1e-5)
CSRC = Path(_build.__file__).resolve().parent / "csrc"


def _cdiv(a, b):
    return -(-a // b)


# --------------------------------------------------------------------------- #
# M <= 8: the weight-streaming plan                                             #
# --------------------------------------------------------------------------- #

#: (m, n, k, vec) -> (kchunk, nsplit, column tiles)
SKINNY_F32 = {
    (3, 256, 128, 4): (128, 1, 8),  # the smoke decoder's decode step
    (3, 11008, 2048, 4): (1024, 2, 344),  # qwen2.5-3b's widths
    (3, 11008, 2048, 1): (1024, 2, 1376),  # the same, 4-byte loads
    (5, 50, 70, 1): (96, 1, 7),
    (3, 130, 77, 1): (96, 1, 17),
    (8, 96, 5000, 4): (160, 32, 3),
    (1, 2048, 2048, 4): (416, 5, 64),
    (2, 16384, 512, 4): (512, 1, 512),  # the column tiles fill the card alone
    (4, 64, 1, 4): (32, 1, 2),
}


@pytest.mark.parametrize("shape", list(SKINNY_F32),
                         ids=["x".join(map(str, s)) for s in SKINNY_F32])
def test_skinny_plan_f32_ranges(shape):
    """The ranges cover K exactly, in whole 32-row steps of at most
    SKINNY_KC rows and at least SKINNY_MIN_K (or one range); they are fixed
    by the shape whatever the column tile (vec 4 or 1), so both routes sum
    every output over the same ranges; and the grid of 16-byte tiles reaches
    the block target, or no range holds twice K's floor (one more range
    would cut one below it)."""
    m, n, k, vec = shape
    kchunk, nsplit, tiles = _build.skinny_plan_f32(m, n, k, vec)
    assert (kchunk, nsplit, tiles) == SKINNY_F32[shape]
    assert tiles == _cdiv(n, 8 * vec)
    assert kchunk % 32 == 0 and kchunk <= _build.SKINNY_KC
    assert (nsplit - 1) * kchunk < k <= nsplit * kchunk
    assert nsplit == 1 or kchunk >= _build.SKINNY_MIN_K
    other = 5 - vec  # 4 <-> 1
    assert _build.skinny_plan_f32(m, n, k, other)[:2] == (kchunk, nsplit)
    grid = _cdiv(n, 32) * nsplit
    assert grid >= _build.SKINNY_TARGET_BLOCKS or kchunk <= 2 * _build.SKINNY_MIN_K
    if _cdiv(n, 32) >= _build.SKINNY_TARGET_BLOCKS and k <= _build.SKINNY_KC:
        assert nsplit == 1


# --------------------------------------------------------------------------- #
# M > 8: the two-weight GEMM's tile and K ranges                                #
# --------------------------------------------------------------------------- #

#: (m, n, k) -> (tile, (kchunk, nsplit))
GEMM_F32 = {
    (45, 256, 128): ((48, 64, 16), (16, 8)),  # the smoke decoder's prefill
    (48, 11008, 2048): ((48, 64, 16), (688, 3)),  # qwen2.5-3b's widths
    (48, 200, 96): ((48, 64, 16), (16, 6)),
    (20, 130, 77): ((48, 64, 16), (32, 3)),
    (100, 200, 96): ((64, 64, 16), (16, 6)),
    (128, 512, 300): ((64, 64, 16), (48, 7)),
    (64, 16384, 4096): ((64, 64, 16), (2048, 2)),
    (2048, 11008, 2048): ((64, 64, 16), (2048, 1)),  # the tiles fill the card alone
    (9, 8, 1): ((48, 64, 16), (16, 1)),
    (9, 64, 0): ((48, 64, 16), (16, 1)),
}


@pytest.mark.parametrize("shape", list(GEMM_F32), ids=["x".join(map(str, s)) for s in GEMM_F32])
def test_ffn_split_f32_ranges(shape):
    """Whole 16-row slabs, at most FFN_SPLIT_MAX ranges (one cluster), the
    ranges cover K exactly; no more blocks than the target unless one
    range, one range where the tiles alone pass half of it; otherwise the
    split stops only at the cluster's size, where a range would hold less
    than twice K's floor, or where one more range would round up to the
    same whole-slab ranges."""
    m, n, k = shape
    tile, plan = GEMM_F32[shape]
    assert _build.ffn_tile_f32(m) == tile
    assert _build.ffn_split_f32(m, n, k) == plan
    kchunk, nsplit = plan
    bm, bn, bk = tile
    assert kchunk % bk == 0 and kchunk >= _build.FFN_SPLIT_MIN_K
    assert 1 <= nsplit <= _build.FFN_SPLIT_MAX
    if k > 0:
        assert (nsplit - 1) * kchunk < k <= nsplit * kchunk
    else:
        assert nsplit == 1
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    assert nsplit == 1 or tiles * nsplit <= _build.FFN_SPLIT_TARGET
    if 2 * tiles > _build.FFN_SPLIT_TARGET:
        assert nsplit == 1
    elif k > 0 and tiles * (nsplit + 1) <= _build.FFN_SPLIT_TARGET:
        same = _cdiv(_cdiv(k, nsplit + 1), bk) * bk == kchunk
        assert nsplit == _build.FFN_SPLIT_MAX or kchunk <= 2 * _build.FFN_SPLIT_MIN_K or same


@pytest.mark.parametrize("m", [9, 20, 45, 48, 49, 64, 96, 100, 129, 2048])
def test_ffn_tile_f32_pads_m_least(m):
    """The tile's rows: the one of FFN_F32_BMS with the fewest padded rows,
    the larger on a tie (48 for the served 45- and 48-row prefills)."""
    bm, bn, bk = _build.ffn_tile_f32(m)
    assert (bn, bk) == (_build.FFN_F32_BN, _build.FFN_F32_BK)
    pads = {b: _cdiv(m, b) * b - m for b in _build.FFN_F32_BMS}
    assert pads[bm] == min(pads.values())
    assert all(pads[b] > pads[bm] or b <= bm for b in pads)


def test_ffn_f32_constants_match_the_cuda_source():
    """The planners' constants are the kernels': tile columns, slab depth,
    the cluster's most ranges, the streaming kernel's K stage, and one
    launch per tile height the planner can pick."""
    src = (CSRC / "ffn_f32.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("BN") == _build.FFN_F32_BN
    assert const("BK") == _build.FFN_F32_BK
    assert const("MAX_SPLIT") == _build.FFN_SPLIT_MAX
    assert const("SK_KC") == _build.SKINNY_KC
    assert const("SK_MAX_M") == _build.SKINNY_MT
    entry = (CSRC / "fused_ffn.cu").read_text()
    launched = {int(b) for b in
                re.findall(r"if \(bm == (\d+)\) return ffn_f32::launch_tiled", entry)}
    assert launched == set(_build.FFN_F32_BMS)


# --------------------------------------------------------------------------- #
# the CPU route against the JAX package                                        #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("activation", ["silu", "gelu", "relu", "tanh"])
@pytest.mark.parametrize("shape", [(48, 200, 96), (3, 130, 77)], ids=["prefill", "decode"])
def test_ffn_gateup_f32_ragged_k_matches_jax(activation, shape):
    """At shapes (m, k, f) whose K the plans cut raggedly (k = 200 in 7
    ranges of 32 rows, the last 8, at m = 48; k = 130 in one 160-row range
    at m = 3) the wrapper's CPU route is the plain version, and both agree
    with the JAX Pallas wrapper and its oracle."""
    assert _build.ffn_split_f32(48, 96, 200) == (32, 7)
    assert _build.skinny_plan_f32(3, 77, 130, 1) == (160, 1, 10)
    m, k, f = shape
    rng = np.random.default_rng(27)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wg = (rng.standard_normal((k, f)) * k ** -0.5).astype(np.float32)
    wu = (rng.standard_normal((k, f)) * k ** -0.5).astype(np.float32)
    xt, gt, ut = torch.from_numpy(x), torch.from_numpy(wg), torch.from_numpy(wu)
    got = tffn.ffn_gateup(xt, gt, ut, activation=activation)
    assert got.dtype == torch.float32 and got.shape == (m, f)
    assert torch.equal(got, tffn.ffn_gateup_plain(xt, gt, ut, activation=activation))
    assert torch.equal(got, tops.ffn_gateup(xt, gt, ut, activation=activation))
    want = jops.ffn_gateup(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
                           activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = jref.ffn_gateup_ref(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
                              activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
