"""The port's plain kernel versions against the JAX package's oracles and its
Pallas wrappers in interpret mode, on the CPU.

Inputs come from a numpy seed and go through both sides as the same arrays.
Tolerance: rtol = atol = 1e-5 per op (f32, summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels import dense_matmul as tdense
from repro_torch.kernels import fused_elementwise as tfused
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(want), **TOL,
    )


T = torch.from_numpy
J = jnp.asarray

# --------------------------------------------------------------------------- #
# conv2d                                                                       #
# --------------------------------------------------------------------------- #

#: (n, c, h, w, o, k, stride, padding)
CONV_CASES = [
    (2, 5, 16, 16, 7, 3, 1, "SAME"),
    (1, 4, 16, 16, 6, 3, 2, "SAME"),  # even input, stride 2: XLA pads (0, 1)
    (2, 3, 15, 13, 5, 3, 2, "SAME"),  # odd input, stride 2
    (1, 6, 11, 9, 4, 3, 1, "VALID"),
    (1, 6, 12, 11, 4, 3, 2, "VALID"),
    (1, 4, 10, 10, 5, 3, 1, ((1, 2), (0, 1))),  # explicit pad pairs
    (1, 4, 9, 9, 5, 3, 2, ((0, 0), (2, 1))),
    (2, 4, 8, 8, 6, 1, 1, "SAME"),  # 1x1
    (1, 3, 14, 14, 4, 7, 1, "SAME"),  # 7x7
    (1, 3, 13, 11, 4, 7, 2, "SAME"),
    (2, 1, 9, 12, 3, 3, 1, "SAME"),  # C = 1
]


@pytest.mark.parametrize("case", CONV_CASES, ids=[str(i) for i in range(len(CONV_CASES))])
@pytest.mark.parametrize("act", [None, "relu"])
def test_conv2d_ref_matches_jax_oracle(case, act):
    n, c, h, w, o, k, stride, padding = case
    rng = _rng(CONV_CASES.index(case))
    x, wt, b = _arr(rng, n, c, h, w), _arr(rng, o, c, k, k, scale=0.3), _arr(rng, o, scale=0.1)
    want = jref.conv2d_ref(J(x), J(wt), J(b), stride=stride, padding=padding, activation=act)
    got = tref.conv2d_ref(T(x), T(wt), T(b), stride=stride, padding=padding, activation=act)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("kind", ["groups", "dilation"])
def test_conv2d_ref_groups_and_dilation_match_jax(kind):
    rng = _rng(7)
    x = _arr(rng, 2, 4, 11, 10)
    kw = {"groups": 2} if kind == "groups" else {"dilation": 2}
    wt = _arr(rng, 6, 2 if kind == "groups" else 4, 3, 3, scale=0.3)
    for stride, padding in ((1, "SAME"), (2, "SAME"), (1, "VALID")):
        want = jref.conv2d_ref(J(x), J(wt), None, stride=stride, padding=padding, **kw)
        got = tref.conv2d_ref(T(x), T(wt), None, stride=stride, padding=padding, **kw)
        _close(got, want)


def test_conv_geometry_helpers_match_jax():
    jconv = jops  # the JAX ops module re-exports the conv geometry helpers
    for h, w in ((16, 16), (15, 13), (37, 29), (8, 5)):
        for k in (1, 3, 7):
            for stride in (1, 2):
                for padding in ("SAME", "VALID", ((1, 2), (0, 1))):
                    if padding == "VALID" and k > min(h, w):
                        continue
                    args = (h, w, k, k, stride, padding)
                    assert tconv.conv_out_hw(*args) == jconv.conv_out_hw(*args)
                    assert tconv.conv_pad_hw(*args) == jconv.conv_pad_hw(*args)
                    assert tconv.conv_padding_token(padding) == jconv.conv_padding_token(padding)


#: the kernel wrapper (plain route on the CPU) against the Pallas kernel in
#: interpret mode: (n, c, h, w, o, k, stride, padding, n_kept, act, epilogue)
GEMM_CONV_CASES = [
    (2, 6, 15, 13, 5, 3, 2, "SAME", 4, "relu", (("add", 0), ("mul", 1))),
    (1, 3, 12, 12, 4, 7, 1, "VALID", None, None, ()),
    (1, 1, 10, 9, 3, 3, 1, ((1, 0), (2, 1)), None, "tanh", (("add", 0),)),
]


@pytest.mark.parametrize("case", GEMM_CONV_CASES, ids=["kept-epi", "7x7-valid", "c1-pads"])
def test_conv2d_gemm_plain_matches_pallas_interpret(case):
    n, c, h, w, o, k, stride, padding, n_kept, act, epi = case
    rng = _rng(11)
    x = _arr(rng, n, c, h, w)
    kept = np.sort(rng.permutation(c)[:n_kept]).astype(np.int32) if n_kept else None
    c_live = n_kept or c
    wt, b = _arr(rng, o, c_live, k, k, scale=0.3), _arr(rng, o, scale=0.1)
    oh, ow = tconv.conv_out_hw(h, w, k, k, stride, padding)
    sides = [_arr(rng, n, o, oh, ow) for _ in range(len(epi))]
    want = jops.conv2d(
        J(x), J(wt), J(b), stride=stride, padding=padding,
        kept=None if kept is None else J(kept), activation=act, epilogue=epi,
        epilogue_sides=[J(s) for s in sides], gemm_1x1=False, interpret=True,
    )
    got = tconv.conv2d_gemm(
        T(x), T(wt), T(b), *map(T, sides), kept=None if kept is None else T(kept),
        stride=stride, padding=padding, activation=act, epilogue=epi,
    )
    _close(got, want)


def test_conv2d_plain_empty_contraction_is_pure_epilogue():
    rng = _rng(3)
    x, b = _arr(rng, 1, 4, 6, 6), _arr(rng, 3)
    wt = np.zeros((3, 0, 3, 3), np.float32)
    got = tconv.conv2d_gemm(T(x), T(wt), T(b), kept=torch.zeros(0, dtype=torch.int32),
                            activation="relu")
    want = np.maximum(np.broadcast_to(b[None, :, None, None], (1, 3, 6, 6)), 0)
    _close(got, want)


# --------------------------------------------------------------------------- #
# matmul                                                                       #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu", "tanh"])
@pytest.mark.parametrize("mnk", [(37, 53, 29), (1, 7, 130), (129, 3, 5)])
def test_matmul_ref_matches_jax_oracle(act, mnk):
    m, n, k = mnk
    rng = _rng(m * 1000 + n)
    x, w, b = _arr(rng, m, k), _arr(rng, k, n, scale=0.2), _arr(rng, n)
    want = jref.matmul_ref(J(x), J(w), J(b), activation=act)
    _close(tref.matmul_ref(T(x), T(w), T(b), activation=act), want)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_dense_matmul_plain_matches_pallas_interpret(act):
    rng = _rng(5)
    m, n, k = 37, 53, 29  # ragged in every dim
    x, w, b = _arr(rng, m, k), _arr(rng, k, n, scale=0.2), _arr(rng, n)
    s0, s1 = _arr(rng, m, n), _arr(rng, m, n)
    epi = (("add", 0), ("activation", "relu"), ("mul", 1))
    want = jops.matmul(J(x), J(w), J(b), activation=act, epilogue=epi,
                       epilogue_sides=[J(s0), J(s1)], interpret=True)
    got = tdense.dense_matmul(T(x), T(w), T(b), T(s0), T(s1), activation=act, epilogue=epi)
    _close(got, want)


def test_dense_matmul_rejects_bad_epilogue():
    x, w = torch.zeros(4, 3), torch.zeros(3, 2)
    with pytest.raises(ValueError):
        tdense.dense_matmul(x, w, None, epilogue=(("add", 0),))
    with pytest.raises(ValueError):
        tdense.dense_matmul(x, w, None, epilogue=(("activation", "swish"),))
    with pytest.raises(ValueError):
        tdense.dense_matmul(x, w, None, activation="swish")


# --------------------------------------------------------------------------- #
# step programs / fused elementwise                                            #
# --------------------------------------------------------------------------- #


def test_apply_steps_ref_matches_jax_incl_instance_norm():
    rng = _rng(9)
    y, s0, s1 = _arr(rng, 2, 5, 6, 7), _arr(rng, 2, 5, 6, 7), _arr(rng, 2, 5, 6, 7)
    sc, bi = _arr(rng, 5) + 1.0, _arr(rng, 5)
    steps = (("add", 0), ("norm_instance", 0, 1e-5), ("activation", "gelu"), ("mul", 1))
    want = jref.apply_steps_ref(J(y), steps, [J(s0), J(s1)], [(J(sc), J(bi))])
    got = tref.apply_steps_ref(T(y), steps, [T(s0), T(s1)], [(T(sc), T(bi))])
    _close(got, want)


@pytest.mark.parametrize("d", [200, 128, 7])
def test_fused_elementwise_layer_norm_matches_jax(d):
    rng = _rng(d)
    m = 19
    x, s0, s1 = _arr(rng, m, d), _arr(rng, m, d), _arr(rng, m, d)
    norms = [(_arr(rng, d) + 1.0, _arr(rng, d)), (_arr(rng, d), _arr(rng, d))]
    steps = (("add", 0), ("norm", 0, 1e-5), ("activation", "silu"), ("mul", 1),
             ("norm", 1, 1e-6))
    jn = [(J(a), J(b)) for a, b in norms]
    tn = [(T(a), T(b)) for a, b in norms]
    want = jref.fused_elementwise_ref(J(x), [J(s0), J(s1)], steps, jn)
    _close(tref.fused_elementwise_ref(T(x), [T(s0), T(s1)], steps, tn), want)
    got = tfused.fused_elementwise(T(x), [T(s0), T(s1)], steps, tn)
    _close(got, want)
    if d == 200:  # D not a multiple of 128: the Pallas kernel masks its lanes
        pallas = jops.fused_elementwise(J(x), [J(s0), J(s1)], steps, jn, interpret=True)
        _close(got, pallas)
