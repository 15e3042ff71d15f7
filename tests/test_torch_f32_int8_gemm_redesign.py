"""The redesigned f32 / INT8 GEMM kernels' host side and the 1x1-conv path
that hands them NCHW tensors, on the CPU.

The CUDA bodies (``csrc/simt_gemm.cuh`` for f32 / W8, ``csrc/int8_gemm.cuh``
for W8A8) run only on the card (``chip_smoke.py``, ``tools/gemm_bench.py``);
what they depend on is plain Python and is held here:

* the NCHW layout's plain versions (``dense_matmul_plain`` /
  ``quant_matmul_plain`` with ``_layout="nchw"``) and the port's 1x1 path
  (``ops._conv2d_1x1_gemm``) against the JAX package's
  ``ops._conv2d_1x1_gemm`` in interpret mode, in every scheme, at stride 1
  and 2, with and without a channel gather, with a residual add and an
  add + mul program, at a ragged 37 x 29 grid;
* the NCHW plain versions ``torch.equal`` to permute -> row-major plain ->
  permute, through every wrapper (tiled and pipelined, every tile);
* that the 1x1 path at stride 1 hands the kernel wrapper the caller's x and
  sides themselves (same storage, NCHW shape) and returns the wrapper's
  own output, with no copy between, under the same tuning key as before;
* the thread layout each body derives from every ``GEMM_TILES`` tuple, and
  ``csrc/tiles.cuh`` equal to ``_build``.

Tolerances: 1e-5 relative (and absolute) for f32 and W8, whose plain
versions sum f32 in another order than XLA; W8A8 too (its int32 sums are
exact, the rescale rounds as JAX's does).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.quant import QTensor as JQTensor
from repro_torch.kernels import _build
from repro_torch.kernels import dense_matmul as tdense
from repro_torch.kernels import dense_matmul_pipelined as tdense_pipe
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_matmul as tquant
from repro_torch.kernels import quant_matmul_pipelined as tquant_pipe
from repro_torch.quant import quantize_array

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def fresh_cache():
    """The port's process-wide tuning cache, emptied, tuning off; restored
    after."""
    cache = tops.tuning_cache()
    state = (cache.enabled, dict(cache.entries), cache.ops_filter, cache.path)
    cache.clear()
    cache.enabled = False
    cache.ops_filter = None
    yield cache
    cache.clear()
    cache.enabled, entries, cache.ops_filter, cache.path = state
    cache.entries.update(entries)


# --------------------------------------------------------------------------- #
# the 1x1 path in the NCHW layout against the JAX package                     #
# --------------------------------------------------------------------------- #

#: (n, c_in, h, w, o, stride, kept, act, epilogue): stride 1 with a residual
#: add, stride 2 at the ragged grid, a channel gather at the ragged grid,
#: an add + mul program, stride 2 with a gather
CASES = [
    (2, 32, 16, 16, 48, 1, None, "relu", "add"),
    (2, 24, 37, 29, 40, 2, None, "relu", None),
    (2, 16, 37, 29, 40, 1, 13, None, "add"),
    (1, 24, 20, 18, 32, 1, None, None, "addmul"),
    (1, 64, 20, 18, 64, 2, 32, "relu", None),
]
CASE_IDS = ["s1-add", "s2-37x29", "kept13of16-37x29-add", "addmul", "s2-kept32of64"]
EPILOGUES = {None: (), "add": (("add", 0),), "addmul": (("add", 0), ("mul", 1))}


def _case(case, scheme, seed):
    n, c_in, h, w, o, stride, n_kept, act, epi_name = case
    rng = np.random.default_rng(seed)
    x = _arr(rng, n, c_in, h, w)
    c = n_kept or c_in
    kept = np.sort(rng.permutation(c_in)[:n_kept]).astype(np.int32) if n_kept else None
    wf = _arr(rng, o, c, 1, 1, scale=c ** -0.5)
    b = _arr(rng, o, scale=0.1)
    oh, ow = -(-h // stride), -(-w // stride)
    epi = EPILOGUES[epi_name]
    sides = [_arr(rng, n, o, oh, ow) for _ in epi]
    return dict(x=x, kept=kept, wf=wf, b=b, stride=stride, act=act, epi=epi, sides=sides,
                scheme=scheme)


def _jax_1x1(d):
    """The JAX package's 1x1 fast path, its kernels in interpret mode."""
    is_q = d["scheme"] != "f32"
    w, w_scale = J(d["wf"]), None
    if is_q:
        qt = JQTensor.from_float(w, axis=0)
        w, w_scale = qt.values, qt.scale
    x_scale = float(np.abs(d["x"]).max()) / 127.0 if d["scheme"] == "w8a8" else None
    y = jops._conv2d_1x1_gemm(
        J(d["x"]), w, J(d["b"]), stride=d["stride"],
        kept=None if d["kept"] is None else J(d["kept"]), w_scale=w_scale, x_scale=x_scale,
        activation=d["act"], epilogue=d["epi"], sides=[J(s) for s in d["sides"]],
        interpret=True, fmt="dense", is_q=is_q)
    return np.asarray(y), (None if w_scale is None else (np.asarray(w), np.asarray(w_scale))), \
        x_scale


@pytest.mark.parametrize("scheme", ["f32", "w8", "w8a8"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_nchw_plain_and_1x1_path_match_jax(case, scheme, fresh_cache):
    d = _case(case, scheme, seed=7 + CASES.index(case))
    want, q, x_scale = _jax_1x1(d)
    x = T(d["x"])
    kept = None if d["kept"] is None else T(d["kept"])
    b, sides = T(d["b"]), [T(s) for s in d["sides"]]
    if scheme == "f32":
        w4, w_scale = T(d["wf"]), None
    else:
        w4, w_scale = T(q[0]), T(q[1])
    got = tops._conv2d_1x1_gemm(
        x, w4, b, stride=d["stride"], kept=kept, w_scale=w_scale, x_scale=x_scale,
        activation=d["act"], epilogue=d["epi"], sides=tuple(sides), fmt="dense")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the NCHW plain version on the operands the 1x1 path hands the wrapper
    xs = x if kept is None else x.index_select(1, kept)
    xs = xs[:, :, ::d["stride"], ::d["stride"]].contiguous()
    w2 = w4.reshape(w4.shape[0], -1)
    kw = dict(activation=d["act"], epilogue=d["epi"], _layout="nchw")
    if scheme == "f32":
        plain = tdense.dense_matmul_plain(xs, w2, b, *sides, **kw)
    else:
        ws = w_scale.float()
        if scheme == "w8a8":
            s = torch.tensor([x_scale], dtype=torch.float32)
            xs, ws = quantize_array(xs, s), ws * s
        plain = tquant.quant_matmul_plain(xs, w2, ws, b, *sides, **kw)
    assert torch.equal(plain, got)


# --------------------------------------------------------------------------- #
# NCHW == permute -> rows -> permute, through every wrapper and tile           #
# --------------------------------------------------------------------------- #

def _rows(t):
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1]).contiguous()


@pytest.mark.parametrize("scheme", ["f32", "w8", "w8a8"])
@pytest.mark.parametrize("hw", [(5, 7), (8, 4)], ids=["5x7", "8x4"])
def test_nchw_wrappers_equal_permuted_row_major(scheme, hw):
    rng = np.random.default_rng(3)
    n, k, o = 2, 20, 12
    x = T(_arr(rng, n, k, *hw))
    wf = T(_arr(rng, o, k, scale=k ** -0.5))
    b = T(_arr(rng, o, scale=0.1))
    sides = [T(_arr(rng, n, o, *hw)) for _ in range(2)]
    kw = dict(activation="relu", epilogue=(("add", 0), ("mul", 1)))
    if scheme == "f32":
        pre, w_nchw, w_row = (), wf, wf.t().contiguous()
        tiled, piped = tdense.dense_matmul, tdense_pipe.dense_matmul_pipelined
    else:
        wq = T(np.clip(np.round(_arr(rng, o, k) * 40), -127, 127).astype(np.int8))
        ws = T(np.abs(_arr(rng, o)) * 0.01 + 1e-3)
        if scheme == "w8a8":
            x = quantize_array(x, torch.tensor([0.05]))
        pre, w_nchw, w_row = (ws,), wq, wq.t().contiguous()
        tiled, piped = tquant.quant_matmul, tquant_pipe.quant_matmul_pipelined
    row = tiled(_rows(x), w_row, *pre, b, *[_rows(s) for s in sides], **kw)
    want = row.reshape(n, *hw, o).permute(0, 3, 1, 2)
    for t in _build.GEMM_TILES:
        fn, more = (tiled, {}) if t[3] == 1 else (piped, {"depth": t[3]})
        got = fn(x, w_nchw, *pre, b, *sides, **kw, **more, block_m=t[0], block_n=t[1],
                 block_k=t[2], _layout="nchw")
        assert got.shape == (n, o, *hw) and got.is_contiguous()
        assert torch.equal(got, want), t


def test_nchw_operand_checks():
    x, w = torch.zeros(2, 8, 3, 3), torch.zeros(5, 8)
    with pytest.raises(ValueError, match="side"):
        tdense.dense_matmul(x, w, None, torch.zeros(2, 5, 9), epilogue=(("add", 0),),
                            _layout="nchw")
    with pytest.raises(ValueError, match="bad NCHW shapes"):
        tdense.dense_matmul(x, torch.zeros(8, 5), _layout="nchw")
    with pytest.raises(ValueError, match="unknown layout"):
        tdense.dense_matmul(x, w, _layout="nhwc")
    with pytest.raises(TypeError, match="NCHW layout"):
        tdense.dense_matmul(x.bfloat16(), w.bfloat16(), _layout="nchw")
    with pytest.raises(_build.TileError):
        tquant.quant_matmul(x, w.to(torch.int8), torch.ones(5), block_m=32, _layout="nchw")
    assert _build.LAYOUT_CODES == {"row": 0, "nchw": 1}


# --------------------------------------------------------------------------- #
# the 1x1 path hands the kernel wrapper NCHW tensors, with no copy            #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("scheme", ["f32", "w8", "w8a8"])
def test_1x1_stride1_hands_the_wrapper_x_itself(scheme, monkeypatch, fresh_cache):
    rng = np.random.default_rng(11)
    n, c, h, w, o = 2, 16, 6, 10, 24
    x = T(_arr(rng, n, c, h, w))
    side = T(_arr(rng, n, o, h, w))
    b = T(_arr(rng, o, scale=0.1))
    if scheme == "f32":
        wt, extra = T(_arr(rng, o, c, 1, 1, scale=0.25)), {}
    else:
        wt = T(np.clip(np.round(_arr(rng, o, c, 1, 1) * 40), -127, 127).astype(np.int8))
        extra = dict(w_scale=T(np.abs(_arr(rng, o)) * 0.01 + 1e-3))
        if scheme == "w8a8":
            extra["x_scale"] = 0.05
    seen = {}
    name = "_dense_matmul" if scheme == "f32" else "_quant_matmul"
    real = getattr(tops, name)

    def spy(xk, wk, *args, **kw):
        seen.update(x=xk, w=wk, sides=args[-1:], layout=kw.get("_layout"))
        seen["out"] = real(xk, wk, *args, **kw)
        return seen["out"]

    monkeypatch.setattr(tops, name, spy)
    y = tops.conv2d(x, wt, b, activation="relu", epilogue=(("add", 0),),
                    epilogue_sides=(side,), **extra)
    assert seen["layout"] == "nchw"
    assert tuple(seen["x"].shape) == (n, c, h, w)
    if scheme == "w8a8":  # quantized elementwise, in the caller's layout
        assert seen["x"].dtype == torch.int8 and seen["x"].is_contiguous()
    else:
        assert seen["x"].data_ptr() == x.data_ptr()
    assert seen["w"].data_ptr() == wt.data_ptr() and tuple(seen["w"].shape) == (o, c)
    assert seen["sides"][0].data_ptr() == side.data_ptr()
    assert y.data_ptr() == seen["out"].data_ptr() and tuple(y.shape) == (n, o, h, w)
    # the same key as the permuting path recorded (M = n * h * w)
    dtype = torch.int8 if scheme == "w8a8" else torch.float32
    fmt = "conv1x1.dense" + ("" if scheme == "f32" else f"+{scheme}") + "+e1s1"
    op = "matmul" if scheme == "f32" else "qmatmul"
    key = tops.TuningCache.key(op, n * h * w, o, c, dtype, fmt, "cpu")
    assert key in fresh_cache.entries, (key, list(fresh_cache.entries))


def test_1x1_stride2_and_kept_gather_once(monkeypatch, fresh_cache):
    """A stride or a channel gather makes the one copy of x; the output is
    still the wrapper's own."""
    rng = np.random.default_rng(12)
    x = T(_arr(rng, 1, 8, 9, 7))
    wt = T(_arr(rng, 4, 5, 1, 1))
    kept = torch.tensor([0, 2, 3, 5, 7], dtype=torch.int32)
    seen = {}
    real = tops._dense_matmul

    def spy(xk, wk, *args, **kw):
        seen["x"] = xk
        seen["out"] = real(xk, wk, *args, **kw)
        return seen["out"]

    monkeypatch.setattr(tops, "_dense_matmul", spy)
    y = tops.conv2d(x, wt, kept=kept, stride=2)
    assert tuple(seen["x"].shape) == (1, 5, 5, 4) and seen["x"].is_contiguous()
    assert y.data_ptr() == seen["out"].data_ptr()
    want = torch.nn.functional.conv2d(x.index_select(1, kept.long()), wt, stride=2)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# the bodies' tiles                                                            #
# --------------------------------------------------------------------------- #

def _macro_tiles(name):
    src = (CSRC / "tiles.cuh").read_text()
    body = src.split(f"#define {name}(X)")[1].split("\n\n")[0]
    return [tuple(int(v) for v in t.split(",")) for t in re.findall(r"X\(([^)]*)\)", body)]


def test_tiles_cuh_equals_build():
    tiled = [(*t, 1) for t in _macro_tiles("REPRO_GEMM_TILED_TILES")]
    assert tuple(tiled + _macro_tiles("REPRO_GEMM_PIPELINED_TILES")) == _build.GEMM_TILES
    src = (CSRC / "simt_gemm.cuh").read_text()
    for line in ("TN = BM * BN / 64 >= 128 ? 8 : 4", "SLOTS = DEPTH + 1", "AP = BM + 4",
                 "BP = BN + 4", "LY = TY < 4 ? TY : 4, LX = 32 / LY",
                 "SMEM = (RING + TILE) * (int)sizeof(float)"):
        assert line in src, line
    src8 = (CSRC / "int8_gemm.cuh").read_text()
    for line in ("BK8 = 4 * BK", "WTN = BN < 32 ? BN : 32", "SLOTS = DEPTH + 1",
                 "AP = BK8 + 16", "RING = SLOTS * (BM + BN) * AP",
                 "SMEM = RING > TILE ? RING : TILE"):
        assert line in src8, line


@pytest.mark.parametrize("tile", _build.GEMM_TILES, ids=lambda t: "x".join(map(str, t)))
def test_f32_body_layout_of_every_tile(tile):
    """simt_gemm.cuh Shape's static asserts, checked before a build: whole
    4-groups a thread, whole warps of 8 x 4 threads, 128 threads, the x
    copies and w elements whole a thread, the shared memory of a block."""
    sh = _build.gemm_shape(tile)
    bm, bn, bk, nt = sh["bm"], sh["bn"], sh["bk"], sh["threads"]
    assert (sh["tm"], sh["tn"]) == ((8, 8) if (bm, bn) == (128, 64) else (8, 4))
    assert nt == 128 and bm % sh["tm"] == 0 and bn % sh["tn"] == 0 and sh["tn"] % 4 == 0
    assert sh["lx"] * sh["ly"] == 32 and sh["tx"] % sh["lx"] == 0 and sh["ty"] % sh["ly"] == 0
    assert (bk * bn) % nt == 0 and sh["w_per_thread"] * nt == bk * bn
    assert nt % bk == 0 and bm % (nt // bk) == 0  # row-major x, 4-byte copies
    assert nt % bm == 0 and bk % (nt // bm) == 0  # NCHW x, 4-byte copies
    assert nt % (bm // 4) == 0 and bk % (nt // (bm // 4)) == 0  # NCHW x, 16-byte copies
    assert sh["slots"] == tile[3] + 1
    tile = max(bm * (bn + 4), bn * (bm + 4))  # the epilogue's output tile, either layout
    assert sh["smem"] == 4 * (sh["slots"] * bk * (bm + 4) + 2 * bk * (bn + 4) + tile)
    assert sh["smem"] <= 227 * 1024


@pytest.mark.parametrize("tile", _build.GEMM_TILES, ids=lambda t: "x".join(map(str, t)))
def test_w8a8_body_layout_of_every_tile(tile):
    """int8_gemm.cuh Shape's constraints: k32 mma steps, warps of two m16
    blocks by n8 blocks, whole transpose units and words a thread, and the
    shared memory an H100 block may have."""
    sh = _build.gemm_w8a8_shape(tile)
    bm, bn, bk8, nt, wn = sh["bm"], sh["bn"], sh["bk"], sh["threads"], sh["warp_n"]
    assert bk8 == 4 * tile[2] and bk8 % 32 == 0
    assert bm % 32 == 0 and wn % 8 == 0 and bn % wn == 0
    assert nt == (bm // 32) * (bn // wn) * 32 and nt <= 1024
    gw = bk8 // 4
    assert nt % gw == 0
    for cols in (bm, bn):  # the transposed operand, either side
        assert ((cols // 4) * gw) % nt == 0 and (cols * gw) % nt == 0
    out_tile = 4 * max(bm * (bn + 4), bn * (bm + 4))
    assert sh["smem"] == max((tile[3] + 1) * (bm + bn) * (bk8 + 16), out_tile) <= 227 * 1024
