"""The redesigned flash-attention and W8A8 conv kernels' host side, on the CPU.

The CUDA bodies run only on the card (``chip_smoke.py``); what they depend
on is plain Python and is held here:

* ``flash_attention.plan``: each shape lands on its documented route --
  ``split`` (Sq <= 8 with at most 64 rows of a KV group, every type pair),
  ``tensor_core`` (bf16 q and k/v past that), ``simt`` (the rest, and any
  unaligned operand) -- and the split route's splits cover every key
  exactly once, within the C entry's limits, fixed by (B, G, Skv) alone;
* the split-and-combine recurrence of the split route and the tiled online
  softmax of the tensor-core route (P as bf16 hi + lo halves), emulated
  step by step in PyTorch, against the JAX package's Pallas attention in
  interpret mode at the routes' edges: a length-0 row, splits past a
  length, causal rows past a short length, GQA ratios 1 / 2 / 8;
* the conv tile table of ``csrc/tiles.cuh`` against ``_build.CONV_TILES``
  and the W8A8 body's own tile derived from each tuple
  (``_build.conv_w8a8_shape``): the mma shape's multiples, whole warps,
  the gather's layout, shared memory;
* ``conv2d_plain`` in the W8A8 scheme against the JAX package at the
  ragged (13 kept channels, O = 40) and stride-2 edges.

Tolerances: 1e-5 (rtol and atol) where both sides sum f32 in another order.
The tensor-core emulation's P V keeps p as a bf16 pair whose sum is within
2^-17 of p, so its outputs sit within 2^-17 x max|v| more: 1e-5 x
max(1, max|v|) covers both.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.quant import QTensor as JQTensor
from repro_torch.kernels import _build
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels import flash_attention as tflash
from repro_torch.quant import quantize_array

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"
BF16, F32 = torch.bfloat16, torch.float32
TYPES = tflash.TYPES
NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------- #
# flash_attention.plan                                                         #
# --------------------------------------------------------------------------- #


def _want_route(h, g, sq, types, aligned):
    if aligned and sq <= tflash.SPLIT_MAX_SQ and (h // g) * sq <= tflash.SPLIT_MAX_ROWS:
        return "split"
    if aligned and types == TYPES[(BF16, BF16)]:
        return "tensor_core"
    return "simt"


@pytest.mark.parametrize("sq", [1, 8, 9, 16, 100, 512])
@pytest.mark.parametrize("types", sorted(TYPES.values()))
@pytest.mark.parametrize("g", [1, 2, 16])
def test_flash_route_is_the_documented_one(sq, types, g):
    for d in (32, 64, 128):
        for aligned in (True, False):
            fp = tflash.plan(3, 16, g, sq, 1024, d, types, causal=True, aligned=aligned)
            assert fp.route == _want_route(16, g, sq, types, aligned), (sq, types, g, d, aligned)
            if fp.route != "split":
                assert (fp.nsplit, fp.chunk) == (1, 1024)
    # the documented edges at qwen2.5-3b's 16 / 2 heads
    bf, mixed = TYPES[(BF16, BF16)], TYPES[(BF16, F32)]
    assert tflash.plan(3, 16, 2, 1, 1024, 128, mixed, False).route == "split"  # decode
    assert tflash.plan(3, 16, 2, 8, 8, 128, bf, True).route == "split"  # 64 rows
    assert tflash.plan(3, 16, 2, 9, 9, 128, bf, True).route == "tensor_core"
    assert tflash.plan(3, 16, 1, 8, 8, 128, bf, True).route == "tensor_core"  # 128 rows
    assert tflash.plan(3, 16, 2, 16, 16, 128, TYPES[(F32, F32)], True).route == "simt"


@pytest.mark.parametrize("b", [1, 2, 3, 8])
@pytest.mark.parametrize("g", [1, 2, 8])
def test_flash_splits_cover_every_key_once(b, g):
    c_src = (CSRC / "flash_attention.cu").read_text()
    c_max_chunk = int(re.search(r"constexpr int MAX_CHUNK = (\d+);", c_src).group(1))
    c_align = int(re.search(r"constexpr int ALIGN = (\d+);", c_src).group(1))
    assert c_align == tflash.SPLIT_ALIGN and tflash.SPLIT_MAX_CHUNK <= c_max_chunk
    for skv in (0, 1, 15, 16, 17, 37, 100, 512, 1000, 1024, 4096, 10000):
        fp = tflash.plan(b, 8 * g, g, 1, skv, 128, 1, False)
        assert fp.route == "split"
        if skv == 0:
            assert (fp.nsplit, fp.chunk) == (1, 0)
            continue
        assert fp.chunk % tflash.SPLIT_ALIGN == 0 and 0 < fp.chunk <= tflash.SPLIT_MAX_CHUNK
        # every split non-empty, the last one ragged: keys [i * chunk, ...)
        assert (fp.nsplit - 1) * fp.chunk < skv <= fp.nsplit * fp.chunk
        covered = np.zeros(skv, np.int32)
        for i in range(fp.nsplit):
            covered[i * fp.chunk:min(skv, (i + 1) * fp.chunk)] += 1
        assert (covered == 1).all()
        # about SPLIT_TARGET CTAs when the span allows, never past it by a split
        if skv >= tflash.SPLIT_MAX_CHUNK * tflash.SPLIT_TARGET:
            assert fp.nsplit * fp.chunk >= skv
        elif skv >= tflash.SPLIT_MIN_CHUNK * math.ceil(tflash.SPLIT_TARGET / (b * g)):
            assert b * g * fp.nsplit >= tflash.SPLIT_TARGET // 2


def test_flash_split_is_fixed_by_batch_groups_and_span():
    """Neither the heads, the query rows, the head dim, the types nor the
    mask move the split: the lengths on the card never reach the plan."""
    for b, g, skv in ((1, 2, 1024), (3, 2, 1024), (3, 2, 4096), (2, 8, 37)):
        splits = {tflash.plan(b, g * r, g, sq, skv, d, t, c)[1:3]
                  for r in (1, 2, 8) for sq in (1, 4, 8) for d in (32, 128)
                  for t in TYPES.values() for c in (False, True)}
        assert len(splits) == 1, (b, g, skv, splits)


def test_flash_constants_mirror_the_cuda_source():
    src = (CSRC / "flash_attention.cu").read_text()
    assert int(re.search(r"constexpr int MAX_ROWS = (\d+);", src).group(1)) == \
        tflash.SPLIT_MAX_ROWS
    assert int(re.search(r"constexpr int BM = (\d+);", src).group(1)) == tflash.TC_ROWS
    assert int(re.search(r"constexpr int KT = (\d+);", src).group(1)) == tflash.TC_KEYS
    for name, code in tflash.ROUTES.items():
        tag = {"simt": "ROUTE_SIMT", "tensor_core": "ROUTE_TC", "split": "ROUTE_SPLIT"}[name]
        assert re.search(rf"{tag} = {code}\b", src), name


def test_flash_plan_for_reads_alignment_from_the_operands():
    q = torch.zeros(2, 8, 8 + 1, 64, dtype=BF16)[:, :, 1:]  # rows 16-byte aligned
    k = torch.zeros(2, 2, 64, 64, dtype=BF16)
    assert tflash.plan_for(q, k, k, True).route == "split"
    odd = torch.zeros(2 * 8 * 8 * 64 + 1, dtype=BF16)[1:].view(2, 8, 8, 64)
    assert tflash.plan_for(odd, k, k, True).route == "simt"


# --------------------------------------------------------------------------- #
# the routes' recurrences, emulated, against the JAX package                   #
# --------------------------------------------------------------------------- #


def _ends(lens, b, sq, skv, causal):
    """Row s of batch row b reads keys [0, end); a length-0 row reads every
    key at -1e30 (``all_masked``)."""
    n = skv if lens is None else int(lens[b])
    all_masked = lens is not None and n <= 0
    ends = [skv if all_masked else min(skv, n, s + 1) if causal else min(skv, n)
            for s in range(sq)]
    return ends, all_masked


def _scores(qs, kt, j0, ends_rows, all_masked):
    """Base-2 scores of stacked rows ``qs`` (already times scale * log2 e)
    against keys ``kt`` starting at ``j0``, masked as the kernel masks."""
    s = qs @ kt.T
    cols = torch.arange(j0, j0 + kt.shape[0])
    if all_masked:
        return torch.full_like(s, NEG_INF)
    ends = torch.tensor(ends_rows)[:, None]
    return torch.where(cols[None, :] < ends, s, torch.tensor(-math.inf))


def emulate_split(q, k, v, lens, causal, scale=None):
    """The split route step by step: per (batch row, group) the stacked rows
    (s * H/G + head) against each split's live keys, one (m, l, acc) partial
    a split (an empty one when the split lies past every row's end), then
    the combine in split order, skipping partials with l = 0."""
    b, h, sq, d = q.shape
    g, skv = k.shape[1], k.shape[2]
    fp = tflash.plan(b, h, g, sq, skv, d, TYPES[(F32, F32)], causal)
    assert fp.route == "split"
    rg, c = h // g, (scale or d ** -0.5) * LOG2E
    out = torch.zeros(b, h, sq, d)
    for bi in range(b):
        ends, all_masked = _ends(lens, bi, sq, skv, causal)
        rows = [(s, hr) for s in range(sq) for hr in range(rg)]
        ends_rows = [ends[s] for s, _ in rows]
        for gi in range(g):
            qs = torch.stack([q[bi, gi * rg + hr, s] for s, hr in rows]) * c
            parts = []
            for sp in range(fp.nsplit):
                j0 = sp * fp.chunk
                n = max(min(j0 + fp.chunk, skv, ends[-1]) - j0, 0)
                if n == 0:
                    parts.append(None)
                    continue
                s = _scores(qs, k[bi, gi, j0:j0 + n], j0, ends_rows, all_masked)
                m = s.max(dim=1).values
                p = torch.exp2(s - torch.where(m == -math.inf, 0.0, m)[:, None])
                parts.append((m, p.sum(dim=1), p @ v[bi, gi, j0:j0 + n]))
            live = [pt for pt in parts if pt is not None]
            mx = torch.stack([torch.where(l > 0, m, torch.tensor(-math.inf))
                              for m, l, _ in live]).max(dim=0).values
            tot_l, acc = torch.zeros(len(rows)), torch.zeros(len(rows), d)
            for m, l, a in live:  # split order
                w = torch.where(l > 0, torch.exp2(m - mx), torch.tensor(0.0))
                tot_l = tot_l + l * w
                acc = acc + a * w[:, None]
            res = acc / torch.clamp(tot_l, min=1e-30)[:, None]
            for ri, (s, hr) in enumerate(rows):
                out[bi, gi * rg + hr, s] = res[ri]
    return out


def emulate_tensor_core(q, k, v, lens, causal, scale=None):
    """The tensor-core route's recurrence per query row: online softmax over
    ``TC_KEYS``-key tiles up to the row's end (tiles past it are skipped),
    P V with p as bf16 hi + lo halves."""
    b, h, sq, d = q.shape
    g, skv = k.shape[1], k.shape[2]
    rg, c, kt = h // g, (scale or d ** -0.5) * LOG2E, tflash.TC_KEYS
    out = torch.zeros(b, h, sq, d)
    for bi in range(b):
        ends, all_masked = _ends(lens, bi, sq, skv, causal)
        for hi in range(h):
            for s in range(sq):
                qs = (q[bi, hi, s] * c)[None]
                m, l, acc = torch.tensor(-math.inf), torch.tensor(0.0), torch.zeros(d)
                for j0 in range(0, ends[s], kt):
                    j1 = min(j0 + kt, skv)
                    x = _scores(qs, k[bi, hi // rg, j0:j1], j0, [ends[s]], all_masked)[0]
                    mn = torch.maximum(m, x.max())
                    mu = torch.where(mn == -math.inf, 0.0, mn)
                    alpha, p = torch.exp2(m - mu), torch.exp2(x - mu)
                    p_hi = p.to(BF16).float()
                    p_lo = (p - p_hi).to(BF16).float()
                    vt = v[bi, hi // rg, j0:j1]
                    acc = acc * alpha + p_hi @ vt + p_lo @ vt
                    l, m = l * alpha + p.sum(), mn
                out[bi, hi, s] = acc / torch.clamp(l, min=1e-30)
    return out


def _jax_attention(q, k, v, lens, causal):
    """The JAX wrapper as the executor calls it: KV groups repeated to the
    query heads, the executor's decode block for one query row."""
    rep = q.shape[1] // k.shape[1]
    kr, vr = np.repeat(k, rep, axis=1), np.repeat(v, rep, axis=1)
    block_q = 8 if q.shape[2] <= 8 else 128
    return np.asarray(jops.attention(J(q), J(kr), J(vr), None if lens is None else J(lens),
                                     causal=causal, block_q=block_q, interpret=True))


#: (b, h, g, sq, skv, d, lengths, causal): GQA ratio 8 with a length-0 row
#: and splits wholly past a length (Skv a multiple of the JAX kernel's
#: 128-key block, so its padded columns do not join the uniform average);
#: ratio 2 with causal rows past a short length; ratio 1 at the split
#: route's Sq edge; decode at qwen2.5-3b's 16 / 2 heads
SPLIT_CASES = [
    (2, 8, 1, 1, 128, 32, [0, 40], False),
    (2, 4, 2, 5, 37, 32, [3, 37], True),
    (1, 4, 4, 8, 70, 64, None, True),
    (3, 16, 2, 1, 96, 32, [96, 50, 1], False),
]
TC_CASES = [
    (2, 8, 2, 20, 20, 32, [20, 7], True),
    (1, 4, 1, 100, 100, 32, None, True),
    (2, 4, 4, 9, 128, 64, [0, 128], False),
]


def _flash_inputs(case, seed, bf16_values):
    b, h, g, sq, skv, d, lengths, causal = case
    rng = np.random.default_rng(seed)
    q, k, v = _arr(rng, b, h, sq, d), _arr(rng, b, g, skv, d), _arr(rng, b, g, skv, d)
    if bf16_values:  # bf16-representable, so both sides take the same values
        q, k, v = (T(a).to(BF16).float().numpy() for a in (q, k, v))
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    return q, k, v, lens, causal


@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: "x".join(map(str, c[:6])))
def test_split_recurrence_matches_jax_attention(case):
    q, k, v, lens, causal = _flash_inputs(case, 0, False)
    fp = tflash.plan(*case[:6], TYPES[(F32, F32)], causal)
    assert fp.route == "split" and fp.nsplit > 1
    got = emulate_split(T(q), T(k), T(v), lens, causal)
    want = _jax_attention(q, k, v, lens, causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # and the port's plain version, which the wrapper runs on the CPU
    plain = tflash.flash_attention(T(q), T(k), T(v), None if lens is None else T(lens),
                                   causal=causal)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)
    if lens is not None and (lens <= 0).any():  # the length-0 row: V's mean over Skv
        bi = int(np.argmin(lens))
        mean = v[bi].mean(axis=1)  # [G, d]
        rep = case[1] // case[2]
        np.testing.assert_allclose(got[bi].numpy(), np.repeat(mean, rep, 0)[:, None].repeat(
            case[3], 1), rtol=1e-5, atol=1e-5)


def test_split_past_a_length_leaves_an_empty_partial():
    """Row 1 (length 40) of the first split case: splits from key 48 on lie
    wholly past it, and the CTA's longest row too, so they stay empty --
    the combine must ignore them, while row 0 (length 0) takes every key."""
    b, h, g, sq, skv, d, lengths, _ = SPLIT_CASES[0]
    fp = tflash.plan(b, h, g, sq, skv, d, TYPES[(F32, F32)], False)
    past = [i for i in range(fp.nsplit) if i * fp.chunk >= lengths[1]]
    assert past and len(past) < fp.nsplit


@pytest.mark.parametrize("case", TC_CASES, ids=lambda c: "x".join(map(str, c[:6])))
def test_tensor_core_recurrence_matches_jax_attention(case):
    q, k, v, lens, causal = _flash_inputs(case, 1, True)
    assert tflash.plan(*case[:6], TYPES[(BF16, BF16)], causal).route == "tensor_core"
    got = emulate_tensor_core(T(q), T(k), T(v), lens, causal)
    want = _jax_attention(q, k, v, lens, causal)
    tol = 1e-5 * max(1.0, float(np.abs(v).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=tol)


# --------------------------------------------------------------------------- #
# the W8A8 conv body's tile                                                    #
# --------------------------------------------------------------------------- #


def _conv_tiles():
    src = (CSRC / "tiles.cuh").read_text()
    body = src.split("#define REPRO_CONV_TILES(X)")[1].split("\n\n")[0]
    return [tuple(int(x) for x in t.split(",")) for t in re.findall(r"X\(([^)]*)\)", body)]


def test_w8a8_tiles_come_from_the_conv_table():
    assert tuple(t[:3] for t in _conv_tiles()) == _build.CONV_TILES
    src = (CSRC / "conv2d.cu").read_text()
    # the derivation _build.conv_w8a8_shape mirrors
    for line in ("BN8 = 2 * BN < 8 ? 8 : 2 * BN", "BK8 = 4 * BK", "WTN = BN8 < 32 ? BN8 : 32",
                 "PPT = BM >= 64 ? 2 : 1", "SMEM = 2 * (BM + BN8) * AP + 2 * BK8 * 16"):
        assert line in src, line
    assert _build.conv_default_tile("w8a8", 32) == (128, 32, 16)
    assert _build.conv_default_tile("w8a8", 128) == (64, 64, 16)


@pytest.mark.parametrize("tile", _conv_tiles(), ids=lambda t: "x".join(map(str, t[:3])))
def test_w8a8_body_tile_fits_the_mma_and_the_gather(tile):
    """conv2d.cu Int8ConvShape's constraints, checked before a build: k32
    slabs and n8 channel blocks of mma.sync m16n8k32, warps of two m16
    blocks, a warp's gather on 32 consecutive pixels, whole words a thread,
    one thread a k of the slab table, the shared memory an H100 block has."""
    sh = _build.conv_w8a8_shape(tile)
    bm, bn, bk, warp_n, nt, ppt = (sh[k] for k in
                                   ("bm", "bn", "bk", "warp_n", "threads", "pixels"))
    assert bk % 32 == 0 and bm % 32 == 0 and bn % 8 == 0 and bn >= tile[1]
    assert warp_n % 8 == 0 and bn % warp_n == 0 and nt == (bm // 32) * (bn // warp_n) * 32
    slots = bm // ppt
    assert slots % 32 == 0 and nt % slots == 0 and (bk // 4) % (nt // slots) == 0
    assert bk <= nt <= 1024
    assert sh["smem"] == 2 * (bm + bn) * (bk + 16) + 2 * bk * 16 <= 227 * 1024


# --------------------------------------------------------------------------- #
# conv2d_plain, W8A8, against the JAX package                                  #
# --------------------------------------------------------------------------- #

#: (n, c_in, h, w, o, k, stride, kept, act, add): 13 kept channels (K = 117,
#: no 16-byte filter rows) into 40 channels; stride 2 with and without a
#: channel gather
W8A8_EDGE = [(2, 16, 37, 29, 40, 3, 1, 13, None, True),
             (2, 24, 37, 29, 40, 3, 2, None, "relu", True),
             (1, 64, 20, 18, 64, 3, 2, 32, "relu", False)]


@pytest.mark.parametrize("case", W8A8_EDGE, ids=["ragged-13of16-o40", "s2-24to40-add",
                                                 "s2-32of64"])
def test_w8a8_conv_plain_matches_jax(case):
    n, c_in, h, wd, o, k, stride, n_kept, act, add = case
    rng = np.random.default_rng(100 + W8A8_EDGE.index(case))
    x = _arr(rng, n, c_in, h, wd)
    kept = np.sort(rng.permutation(c_in)[:n_kept]).astype(np.int32) if n_kept else None
    qt = JQTensor.from_float(J(_arr(rng, o, n_kept or c_in, k, k, scale=0.3)), axis=0)
    b = _arr(rng, o, scale=0.1)
    oh, ow = -(-h // stride), -(-wd // stride)
    sides = [_arr(rng, n, o, oh, ow)] if add else []
    epi = (("add", 0),) if add else ()
    x_scale = float(np.abs(x).max()) / 127.0
    want = jops.conv2d(J(x), qt.values, J(b), w_scale=qt.scale, x_scale=x_scale,
                       kept=None if kept is None else J(kept), stride=stride,
                       activation=act, epilogue=epi, epilogue_sides=[J(s) for s in sides],
                       interpret=True)
    # the operands as ops.conv2d hands them to the kernel: int8 activations,
    # the activation scale folded into the per-channel rescale
    xq = quantize_array(T(x), torch.tensor([x_scale]))
    ws = T(np.array(qt.scale)) * torch.tensor(x_scale, dtype=torch.float32)
    args = (xq, T(np.array(qt.values)), T(b), *[T(s) for s in sides])
    kw = dict(ws=ws, kept=None if kept is None else T(kept), stride=stride, activation=act,
              epilogue=epi)
    got = tconv.conv2d_plain(*args, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # through the wrapper (the plain version on the CPU, every tile alike)
    before = tconv.scheme_launches["w8a8"]
    for tile in _build.CONV_TILES:
        out = tconv.conv2d_gemm(*args, **kw, block_m=tile[0], block_n=tile[1],
                                block_k=tile[2])
        assert torch.equal(out, got)
    assert tconv.scheme_launches["w8a8"] == before
