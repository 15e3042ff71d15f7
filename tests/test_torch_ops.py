"""The port's ``kernels.ops`` layer on the CPU against ``repro.kernels.ops``
(Pallas in interpret mode): outputs at rtol = atol = 1e-5, and the routing
decisions -- the 1x1 fast-path election and the fallback matrix's reasons --
counted the same way in both packages' metrics registries."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.obs import metrics as tmetrics

TOL = dict(rtol=1e-5, atol=1e-5)
T = torch.from_numpy
J = jnp.asarray


@pytest.fixture(autouse=True)
def _port_registry():
    """The port keeps its own metrics registry; restore it around each test
    (``tests/conftest.py`` isolates only the JAX package's)."""
    snap = tmetrics.registry().dump_state()
    tops.reset_kernel_launches()
    try:
        yield
    finally:
        tmetrics.registry().load_state(snap)


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


#: (n, c, h, w, o, k, stride, n_kept, act, n_sides)
OPS_CONV_CASES = [
    (2, 6, 9, 8, 5, 1, 2, 4, "relu", 2),  # 1x1 fast path: stride, kept, sides
    (1, 5, 8, 8, 7, 1, 1, None, None, 1),
    (2, 6, 11, 10, 4, 3, 2, 3, "relu", 1),  # implicit-GEMM kernel route
    (1, 3, 12, 12, 4, 7, 1, None, "tanh", 0),
]


#: an epilogue program per number of side operands
EPILOGUES = {0: (), 1: (("add", 0),), 2: (("add", 0), ("mul", 1), ("activation", "silu"))}


@pytest.mark.parametrize("case", OPS_CONV_CASES, ids=["1x1-s2-kept", "1x1", "3x3-kept", "7x7"])
def test_ops_conv2d_matches_jax_and_elects_alike(case):
    n, c, h, w, o, k, stride, n_kept, act, n_sides = case
    rng = np.random.default_rng(OPS_CONV_CASES.index(case))
    x = _arr(rng, n, c, h, w)
    kept = np.sort(rng.permutation(c)[:n_kept]).astype(np.int32) if n_kept else None
    wt, b = _arr(rng, o, n_kept or c, k, k, scale=0.3), _arr(rng, o, scale=0.1)
    oh, ow = tops.conv_out_hw(h, w, k, k, stride, "SAME")
    sides = [_arr(rng, n, o, oh, ow) for _ in range(n_sides)]
    epi = EPILOGUES[n_sides]
    jops.reset_conv_fastpaths()
    tops.reset_conv_fastpaths()
    want = jops.conv2d(J(x), J(wt), J(b), stride=stride, kept=None if kept is None else J(kept),
                       activation=act, epilogue=epi, epilogue_sides=[J(s) for s in sides],
                       interpret=True)
    got = tops.conv2d(T(x), T(wt), T(b), stride=stride, kept=None if kept is None else T(kept),
                      activation=act, epilogue=epi, epilogue_sides=[T(s) for s in sides])
    _close(got, want)
    assert tops.conv_fastpath_counts() == jops.conv_fastpath_counts()
    assert tops.conv_fastpath_counts() == ({"f32": 1} if k == 1 else {})


def _fallback_case(reason):
    rng = np.random.default_rng(1)
    x = _arr(rng, 1, 4, 8, 8)
    if reason == "groups":
        return x, _arr(rng, 4, 2, 3, 3, scale=0.3), dict(groups=2)
    if reason == "dilation":
        return x, _arr(rng, 4, 4, 3, 3, scale=0.3), dict(dilation=2)
    if reason == "padding":
        return x, _arr(rng, 4, 4, 3, 3, scale=0.3), dict(padding=((-1, 1), (0, 1)))
    return x, _arr(rng, 4, 4, 9, 9, scale=0.3), dict(padding="VALID")  # degenerate


@pytest.mark.parametrize("reason", ["groups", "dilation", "padding", "degenerate"])
def test_ops_conv2d_fallback_matrix_matches_jax(reason):
    x, wt, kw = _fallback_case(reason)
    jops.reset_conv_fallbacks()
    tops.reset_conv_fallbacks()
    want = jops.conv2d(J(x), J(wt), None, interpret=True, **kw)
    got = tops.conv2d(T(x), T(wt), None, **kw)
    assert tops.conv_fallback_counts() == jops.conv_fallback_counts() == {reason: 1}
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)
    assert tops.kernel_launch_counts()["conv2d"] == 0  # plain route, no kernel


def test_conv_routing_predicates_match_jax():
    pads = ["SAME", "VALID", ((0, 0), (0, 0)), ((1, 0), (0, 0)), ((-1, 0), (0, 0)), "bogus"]
    for kh in (1, 3):
        for groups in (1, 2):
            for c in (0, 4):
                for padding in pads[:-1]:
                    assert tops.conv_gemm1x1_elected(kh, kh, groups, padding, c) == \
                        jops.conv_gemm1x1_elected(kh, kh, groups, padding, c)
    for h in (2, 8):
        for k in (1, 3):
            for stride in (1, 2):
                for padding in pads:
                    for groups, dilation in ((1, 1), (2, 1), (1, 2)):
                        want = jops.conv_fallback_reason(
                            4, h, h, k, k, stride, padding, groups=groups, dilation=dilation,
                            interpret=True,
                        )
                        got = tops.conv_fallback_reason(
                            4, h, h, k, k, stride, padding, groups=groups, dilation=dilation,
                        )
                        assert got == want, (h, k, stride, padding, groups, dilation)


def test_ops_matmul_leading_batch_and_col_matmul_match_jax():
    rng = np.random.default_rng(2)
    x = _arr(rng, 2, 3, 21)
    w, b = _arr(rng, 21, 13, scale=0.2), _arr(rng, 13)
    s0 = _arr(rng, 2, 3, 13)
    epi = (("mul", 0), ("activation", "gelu"))
    want = jops.matmul(J(x), J(w), J(b), activation="relu", epilogue=epi,
                       epilogue_sides=[J(s0)], interpret=True)
    got = tops.matmul(T(x), T(w), T(b), activation="relu", epilogue=epi, epilogue_sides=[T(s0)])
    _close(got, want)
    kept = np.array([0, 3, 4, 9, 20], np.int32)
    vals = _arr(rng, 5, 13, scale=0.2)
    want = jops.col_matmul(J(x), J(vals), J(kept), J(b), activation="tanh", interpret=True)
    got = tops.col_matmul(T(x), T(vals), T(kept), T(b), activation="tanh")
    _close(got, want)


def test_ops_fused_elementwise_matches_jax():
    rng = np.random.default_rng(3)
    x, s0, s1 = _arr(rng, 2, 3, 5, 40), _arr(rng, 2, 3, 5, 40), _arr(rng, 2, 3, 5, 40)
    norms = [(_arr(rng, 40) + 1.0, _arr(rng, 40))]
    steps = (("add", 0), ("add", 1), ("norm", 0, 1e-5), ("activation", "relu"))
    want = jops.fused_elementwise(J(x), [J(s0), J(s1)], steps,
                                  [(J(a), J(b)) for a, b in norms], interpret=True)
    got = tops.fused_elementwise(T(x), [T(s0), T(s1)], steps, [(T(a), T(b)) for a, b in norms])
    assert tuple(got.shape) == x.shape
    _close(got, want)


def test_cpu_calls_launch_no_kernel():
    rng = np.random.default_rng(4)
    x = T(_arr(rng, 1, 4, 6, 6))
    tops.conv2d(x, T(_arr(rng, 3, 4, 3, 3)))
    tops.conv2d(x, T(_arr(rng, 3, 4, 1, 1)))
    tops.fused_elementwise(x, [x], (("add", 0),))
    assert tops.kernel_launch_counts() == {"conv2d": 0, "dense_matmul": 0, "fused_elementwise": 0}
