"""The bf16 ``ffn_gateup`` on the Hopper body with two weights
(``csrc/wgmma_gemm.cuh`` with NW = 2, run by ``csrc/fused_ffn.cu``), as far
as the CPU reaches it: the rule that picks a body (``_build.ffn_body``), the
plan fixed by the shape (``_build.ffn_tma_plan``), the two-weight ring's
shared memory and instances against the CUDA sources, and the body's
summation order emulated in torch against the JAX package's Pallas
``ffn_gateup`` in interpret mode.  No model is built and no process is
started: every test is a pure function of ``_build`` or one small call.

Tolerance for bf16 outputs: one bf16 ulp of max|ref| (both sides sum in
f32 and round once; the order of the sums differs).
"""

import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import fused_ffn as tffn
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import _ACT, bf16_ulp

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
BF16 = torch.bfloat16
#: an H100's SMs, and the shared memory one holds (228 KB; 1 KB of it is
#: reserved for each resident CTA)
SMS, SM_SMEM, CTA_RESERVED = 132, 228 * 1024, 1024


def _gate_up_shapes():
    """``(label, m, f, k)``: the gate/up of the three served decoders at
    decode (M = 3) and prefill (M = 48), and qwen3-14b's 5120 -> 17408."""
    out = []
    for arch in ("qwen2.5-3b", "granite-3-2b", "phi4-mini-3.8b", "qwen3-14b"):
        c = get_config(arch)
        for m in (3, 48):
            out.append((f"{arch.split('-')[0]}-M{m}", m, c.d_ff, c.d_model))
    return out


SHAPES = _gate_up_shapes()


def test_the_gate_up_shapes_are_the_served_widths():
    assert {(m, f, k) for _, m, f, k in SHAPES} == {
        (m, f, k) for m in (3, 48)
        for f, k in ((11008, 2048), (8192, 2048), (8192, 3072), (17408, 5120))}


# --------------------------------------------------------------------------- #
# the rule                                                                     #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("label,m,f,k", SHAPES, ids=[s[0] for s in SHAPES])
def test_gate_up_shapes_take_the_wgmma_body(label, m, f, k):
    """Prefill and decode alike go to the two-weight TMA + wgmma body where
    TMA addresses the operands; unaligned operands (a weight 2 bytes past a
    16-byte boundary) keep ``mma_gemm``."""
    assert _build.ffn_body(f, k) == "wgmma"
    assert _build.ffn_body(f, k, aligned=False) == "mma_gemm"


@pytest.mark.parametrize("f,k", [(77, 130), (50, 70), (11010, 2048), (11008, 2044), (8, 0),
                                 (8, 8)], ids=lambda v: str(v))
def test_odd_ragged_and_empty_launches_keep_mma_gemm(f, k):
    """Rows that are not whole 16 bytes (odd K or F, as M=20 K=130 F=77 and
    M=5 K=70 F=50) or an empty K keep the ``mma_gemm`` body, whatever M (the
    rule does not take it); any aligned K, F multiple of 8 is TMA's."""
    assert list(inspect.signature(_build.ffn_body).parameters) == ["f", "k", "aligned"]
    want = "wgmma" if k > 0 and k % 8 == 0 and f % 8 == 0 else "mma_gemm"
    assert _build.ffn_body(f, k) == want
    assert _build.ffn_body(f, k, aligned=False) == "mma_gemm"


def test_route_launches_count_nothing_on_cpu_and_reset():
    x = torch.zeros(48, 64, dtype=BF16)
    w = torch.zeros(64, 32, dtype=BF16)
    tffn.route_launches["wgmma"] += 3
    tops.reset_kernel_launches()
    tffn.ffn_gateup(x, w, w)
    tffn.ffn_gateup(x.float(), w.float(), w.float())
    assert set(tffn.route_launches) == {"wgmma", "mma_gemm", "simt", "stream"}
    assert not any(tffn.route_launches.values()) and tffn.launches == 0


# --------------------------------------------------------------------------- #
# the plan                                                                     #
# --------------------------------------------------------------------------- #


PLAN_SHAPES = [(m, f, k) for _, m, f, k in SHAPES] + [
    (48, 128, 256), (9, 8, 8), (1000, 4096, 4096), (64, 4096, 100000), (130, 200, 2056),
    (3, 64, 128)]


@pytest.mark.parametrize("m,f,k", PLAN_SHAPES, ids=["x".join(map(str, s)) for s in PLAN_SHAPES])
def test_ffn_tma_plan_covers_k_in_whole_ranges_and_fits_a_cluster(m, f, k):
    """A tile of the two-weight list; K ranges that cover K exactly in whole
    ``TMA_SPLIT_ALIGN`` steps (so whole slabs of every tile's BK), at most
    a cluster's worth, none shorter than ``SPLIT_MIN_K`` unless there is
    one; a split grid never past the CTAs two an SM hold."""
    tile, kchunk, nsplit = _build.ffn_tma_plan(m, f, k)
    assert tile in _build.FFN_WGMMA_TILES
    assert kchunk % _build.TMA_SPLIT_ALIGN == 0
    assert all(kchunk % bk == 0 for _, _, bk, _ in _build.FFN_WGMMA_TILES)
    assert (nsplit - 1) * kchunk < k <= nsplit * kchunk
    assert 1 <= nsplit <= _build.TMA_MAX_CLUSTER
    assert nsplit == 1 or kchunk >= _build.SPLIT_MIN_K
    tiles = -(-m // tile[0]) * -(-f // tile[1])
    assert nsplit == 1 or tiles * nsplit <= _build.FFN_TMA_TARGET
    # the 96 KB ring while its grid fits two CTAs an SM, else the 48 KB one
    assert tile == _build.FFN_WGMMA_TILES[int(tiles > _build.FFN_TMA_TARGET)]


def test_ffn_tma_plan_depends_on_the_shape_alone():
    """The plan takes the shape and nothing else, so every tile sums each
    output over the same ranges; at the served widths it is the same at
    decode and prefill (one 64-row tile either way)."""
    assert list(inspect.signature(_build.ffn_tma_plan).parameters) == ["m", "f", "k"]
    wide, narrow = _build.FFN_WGMMA_TILES
    want = {(11008, 2048): (wide, 2048, 1), (8192, 2048): (wide, 1024, 2),
            (8192, 3072): (wide, 1536, 2), (17408, 5120): (narrow, 5120, 1)}
    for _, m, f, k in SHAPES:
        assert _build.ffn_tma_plan(m, f, k) == want[(f, k)], (m, f, k)
    assert _build.FFN_TMA_TARGET == 2 * SMS


# --------------------------------------------------------------------------- #
# the ring and the CUDA sources                                                #
# --------------------------------------------------------------------------- #


def _macro_tiles(name):
    src = (CSRC / "tiles.cuh").read_text()
    body = src.split(f"#define {name}(X)")[1].split("\n\n")[0]
    return [tuple(int(v) for v in t.split(",")) for t in re.findall(r"X\(([^)]*)\)", body)]


@pytest.mark.parametrize("tile", _build.FFN_WGMMA_TILES,
                         ids=["x".join(map(str, t)) for t in _build.FFN_WGMMA_TILES])
def test_two_weight_ring_and_partial_tiles_fit_shared_memory(tile):
    """Each two-weight tile's ring (a slot: one x box and a box of each
    weight) and its two partial tiles fit a block's 227 KB; the partial
    tiles fit the drained ring; the first tile keeps two CTAs an SM
    resident, the second four."""
    shape = _build.wgmma_shape(tile, 2)
    bm, bn, bk, depth = tile
    assert shape["smem"] <= _build.SMEM_LIMIT == 227 * 1024
    assert shape["ring"] == shape["stages"] * 2 * (bm * bk + 2 * bk * bn)
    assert _build.TMA_MIN_STAGES <= shape["stages"] <= 2 + 2 * depth
    assert shape["ring"] <= _build.TMA_RING_BUDGET
    assert shape["partial"] == 2 * bm * (bn + 8) * 4 <= shape["ring"]
    assert shape["threads"] == bm // 64 * 128 + 32
    resident = SM_SMEM // (shape["smem"] + CTA_RESERVED)
    assert resident == {0: 2, 1: 4}[_build.FFN_WGMMA_TILES.index(tile)]
    assert _build.wgmma_shape(tile) == _build.wgmma_shape(tile, 1)


def test_two_weight_instances_match_the_tile_list():
    """tiles.cuh's two-weight list is the fused_ffn.cu wgmma instances (NW =
    2), no bf16 gate/up launch goes to the skinny kernel any more, and the
    header derives the slot, the partial tiles and the third copy from NW as
    ``_build.wgmma_shape`` does."""
    assert tuple(_macro_tiles("REPRO_FFN_WGMMA_TILES")) == _build.FFN_WGMMA_TILES
    entry = (CSRC / "fused_ffn.cu").read_text()
    assert '#include "wgmma_gemm.cuh"' in entry
    assert "REPRO_FFN_WGMMA_TILES(REPRO_TRY_TMA)" in entry
    assert "wgmma_gemm::launch_nw<BM, BN, BK, DEPTH, 2>" in entry
    assert "skinny_bf16" not in entry
    head = (CSRC / "wgmma_gemm.cuh").read_text()
    for line in ("template <int BM, int BN, int BK, int DEPTH, int NW = 1>",
                 "SLOT = X_SLOT + NW * W_SLOT", "NW * PART <= RING",
                 "tma_load(xs + T::X_SLOT + T::W_SLOT, um, fb, n0, k0)",
                 "launch_nw<BM, BN, BK, DEPTH, 1>(x, w, nullptr, out"):
        assert line in head, line


# --------------------------------------------------------------------------- #
# the body's summation order against the JAX package                          #
# --------------------------------------------------------------------------- #


def _emulate_body(x, wg, wu, activation):
    """The two-weight body's arithmetic in torch: each K range of the plan
    summed in ascending k16 steps into f32 gate and up accumulators from
    +0, the ranges added in split order, ``act(g) * u`` in f32 and rounded
    once to bf16."""
    m, k = x.shape
    f = wg.shape[1]
    _, kchunk, nsplit = _build.ffn_tma_plan(m, f, k)
    parts = []
    for r in range(nsplit):
        acc = [torch.zeros(m, f), torch.zeros(m, f)]
        for k0 in range(r * kchunk, min(k, (r + 1) * kchunk), 16):
            xs = x[:, k0:k0 + 16].float()
            acc = [a + xs @ w[k0:k0 + 16].float() for a, w in zip(acc, (wg, wu))]
        parts.append(acc)
    g, u = parts[0]
    for pg, pu in parts[1:]:
        g, u = g + pg, u + pu
    return (_ACT[activation](g) * u).to(BF16)


def test_emulated_body_matches_jax_pallas_ffn_gateup():
    """At M=48 K=256 F=128 bf16 silu (two K ranges of 128 rows) the body's
    summation order lands within one bf16 ulp of the JAX package's Pallas
    ``ffn_gateup`` in interpret mode and of the port's plain version."""
    assert _build.ffn_tma_plan(48, 128, 256)[1:] == (128, 2)
    rng = np.random.default_rng(34)
    arrs = [rng.standard_normal((48, 256)), rng.standard_normal((256, 128)) * 256 ** -0.5,
            rng.standard_normal((256, 128)) * 256 ** -0.5]
    bf = [a.astype(np.float32).astype(ml_dtypes.bfloat16) for a in arrs]
    xt, gt, ut = (torch.from_numpy(a.astype(np.float32)).to(BF16) for a in bf)
    got = _emulate_body(xt, gt, ut, "silu")
    want = np.asarray(jops.ffn_gateup(*(jnp.asarray(a) for a in bf), activation="silu",
                                      interpret=True), np.float32)
    tol = bf16_ulp(float(np.abs(want).max()))
    assert np.abs(got.float().numpy() - want).max() <= tol
    plain = tffn.ffn_gateup_plain(xt, gt, ut, activation="silu").float()
    assert (got.float() - plain).abs().max().item() <= bf16_ulp(plain.abs().max().item())
    assert torch.equal(tffn.ffn_gateup(xt, gt, ut, activation="silu"), plain.to(BF16))
