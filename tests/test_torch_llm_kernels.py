"""The decoder's kernels in the port (flash attention, the fused gate/up FFN,
the bf16 dense matmul) and their step programs, held against the JAX
package on the CPU: the port's plain versions (which its wrappers run for
CPU tensors) against the JAX Pallas wrappers in interpret mode and the JAX
oracles, on the same numpy-seeded arrays.

Tolerances: 1e-5 (rtol and atol) in f32, where only the summation order
differs.  bf16 outputs: one bf16 ulp of max|ref| -- both sides accumulate in
f32 and round to bf16 once, but the two frameworks sum in another order, so
a value near a rounding boundary may land on the neighbouring bf16 number.
"""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import dense_matmul as tdense
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import fused_ffn as tffn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-5, atol=1e-5)
BF16 = ml_dtypes.bfloat16


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def bf16_ulp(x: float) -> float:
    """One bf16 ulp (8 significant bits) at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


def _close_bf16(got, want):
    g, w = _np(got), _np(want)
    assert np.max(np.abs(g - w)) <= bf16_ulp(float(np.max(np.abs(w)))), np.max(np.abs(g - w))


def _bf16_pair(a):
    """The same bf16 values for both sides: an ml_dtypes array for JAX and a
    torch bf16 tensor for the port."""
    b = a.astype(BF16)
    return jnp.asarray(b), torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16)


# --------------------------------------------------------------------------- #
# flash attention                                                              #
# --------------------------------------------------------------------------- #

#: (b, h, g, sq, skv, d, lengths, causal)
FLASH_CASES = [
    (2, 4, 4, 37, 37, 32, None, True),  # S not a multiple of 128
    (2, 4, 2, 37, 37, 32, [37, 20], True),  # GQA + prefill lengths (padded rows)
    (2, 4, 2, 1, 64, 32, [10, 63], False),  # decode: one query, padded span
    (3, 4, 2, 1, 48, 64, [1, 17, 48], False),
    (1, 2, 2, 128, 128, 32, None, False),  # non-causal, block-aligned
    (2, 4, 1, 19, 19, 32, [19, 7], True),  # one KV group for all heads
]


def _flash_inputs(case, seed):
    b, h, g, sq, skv, d, lengths, causal = case
    rng = np.random.default_rng(seed)
    q, k, v = _arr(rng, b, h, sq, d), _arr(rng, b, g, skv, d), _arr(rng, b, g, skv, d)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    return q, k, v, lens, causal


def _jax_flash(q, k, v, lens, causal, h, block_q=128):
    """The JAX wrapper as the executor calls it: KV groups repeated to the
    query heads (``_attn_heads``)."""
    rep = h // k.shape[1]
    kr, vr = np.repeat(k, rep, axis=1), np.repeat(v, rep, axis=1)
    return jops.attention(
        jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr),
        None if lens is None else jnp.asarray(lens), causal=causal, block_q=block_q,
    ), (kr, vr)


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "x".join(map(str, c[:6])))
def test_flash_attention_plain_matches_jax_wrapper_and_ref(case):
    q, k, v, lens, causal = _flash_inputs(case, 0)
    h = case[1]
    got = tflash.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if lens is None else torch.from_numpy(lens), causal=causal,
    )
    block_q = 8 if q.shape[2] == 1 else 128  # the executor's decode block
    want, (kr, vr) = _jax_flash(q, k, v, lens, causal, h, block_q)
    _close(got, want)
    ref = jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr),
        None if lens is None else jnp.asarray(lens), causal=causal,
    )
    _close(got, ref)


@pytest.mark.parametrize("case", FLASH_CASES[:3], ids=lambda c: "x".join(map(str, c[:6])))
def test_flash_attention_wrapper_on_cpu_is_the_plain_version_and_counts_nothing(case):
    q, k, v, lens, causal = _flash_inputs(case, 1)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    ln = None if lens is None else torch.from_numpy(lens)
    before = tops.kernel_launch_counts()["flash_attention"]
    got = tops.attention(*args, ln, causal=causal)
    want = tflash.flash_attention_plain(*args, ln, causal=causal)
    assert torch.equal(got, want)
    assert tops.kernel_launch_counts()["flash_attention"] == before


def test_flash_attention_scale_and_ref_match_jax_ref():
    q, k, v, lens, _ = _flash_inputs(FLASH_CASES[1], 2)
    kr, vr = np.repeat(k, 2, axis=1), np.repeat(v, 2, axis=1)
    got = tref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(kr),
                                   torch.from_numpy(vr), torch.from_numpy(lens),
                                   causal=False, scale=0.3)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr),
                                    jnp.asarray(lens), causal=False, scale=0.3)
    _close(got, want)


def test_flash_attention_zero_length_row_averages_values_and_stays_finite():
    """A row whose every key is masked (length 0) averages V uniformly with
    -1e30 masking, exactly as the oracle does; -inf would give NaN."""
    q, k, v, _, _ = _flash_inputs((1, 2, 2, 3, 9, 32, None, False), 3)
    got = tflash.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), torch.tensor([0], dtype=torch.int32),
                                       causal=False)
    assert torch.isfinite(got).all()
    mean_v = torch.from_numpy(v).mean(dim=2, keepdim=True).expand_as(got)
    torch.testing.assert_close(got, mean_v, rtol=1e-5, atol=1e-5)


def test_flash_attention_decode_bf16_query_f32_span_matches_jax():
    """The decode merge's types: bf16 queries against an f32 cache span,
    output in the query's type."""
    q, k, v, lens, _ = _flash_inputs((2, 4, 2, 1, 40, 32, [40, 13], False), 4)
    qj, qt = _bf16_pair(q)
    kr, vr = np.repeat(k, 2, axis=1), np.repeat(v, 2, axis=1)
    want = jops.attention(qj, jnp.asarray(kr), jnp.asarray(vr), jnp.asarray(lens),
                          causal=False, block_q=8)
    got = tflash.flash_attention_plain(qt, torch.from_numpy(k), torch.from_numpy(v),
                                       torch.from_numpy(lens), causal=False)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close_bf16(got, want)


def test_flash_attention_prefill_bf16_matches_jax():
    q, k, v, lens, _ = _flash_inputs((2, 4, 2, 16, 16, 32, [16, 9], True), 5)
    (qj, qt), (kj, kt), (vj, vt) = _bf16_pair(q), _bf16_pair(k), _bf16_pair(v)
    want = jops.attention(qj, jnp.repeat(kj, 2, axis=1), jnp.repeat(vj, 2, axis=1),
                          jnp.asarray(lens), causal=True)
    got = tflash.flash_attention_plain(qt, kt, vt, torch.from_numpy(lens), causal=True)
    _close_bf16(got, want)


# --------------------------------------------------------------------------- #
# fused gate/up FFN                                                            #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("activation", ["silu", "gelu", "relu", "tanh"])
@pytest.mark.parametrize("shape", [(2, 17, 40, 50), (1, 3, 128, 256)], ids=["ragged", "smoke"])
def test_ffn_gateup_plain_matches_jax_wrapper_and_ref(activation, shape):
    b, s, d, f = shape
    rng = np.random.default_rng(6)
    x = _arr(rng, b, s, d)
    wg, wu = _arr(rng, d, f, scale=d ** -0.5), _arr(rng, d, f, scale=d ** -0.5)
    got = tops.ffn_gateup(torch.from_numpy(x), torch.from_numpy(wg), torch.from_numpy(wu),
                          activation=activation)
    want = jops.ffn_gateup(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
                           activation=activation)
    _close(got, want)
    ref = jref.ffn_gateup_ref(jnp.asarray(x.reshape(-1, d)), jnp.asarray(wg), jnp.asarray(wu),
                              activation=activation)
    _close(got.reshape(-1, f), ref)
    plain = tffn.ffn_gateup_plain(torch.from_numpy(x.reshape(-1, d)), torch.from_numpy(wg),
                                  torch.from_numpy(wu), activation=activation)
    assert torch.equal(got.reshape(-1, f), plain)


def test_ffn_gateup_bf16_matches_jax():
    rng = np.random.default_rng(7)
    (xj, xt), (gj, gt), (uj, ut) = (
        _bf16_pair(_arr(rng, 5, 64)), _bf16_pair(_arr(rng, 64, 96, scale=0.125)),
        _bf16_pair(_arr(rng, 64, 96, scale=0.125)),
    )
    want = jops.ffn_gateup(xj, gj, uj, activation="silu")
    got = tffn.ffn_gateup(xt, gt, ut, activation="silu")
    assert got.dtype == torch.bfloat16
    _close_bf16(got, want)


def test_ffn_gateup_rejects_bad_shapes_and_activation():
    x, w = torch.zeros(3, 4), torch.zeros(4, 5)
    with pytest.raises(ValueError, match="bad shapes"):
        tffn.ffn_gateup(x, w, torch.zeros(4, 6))
    with pytest.raises(ValueError, match="activation"):
        tffn.ffn_gateup(x, w, w, activation="swish")
    with pytest.raises(ValueError, match="no kernel for device"):
        tffn.ffn_gateup(x.to("meta"), w.to("meta"), w.to("meta"))


# --------------------------------------------------------------------------- #
# RoPE and the decoder's step-program steps                                    #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("heads,dh,theta", [(4, 32, 1e6), (2, 32, 1e4), (3, 8, 500.0)])
def test_rope_ref_matches_jax(heads, dh, theta):
    rng = np.random.default_rng(8)
    x = _arr(rng, 2, 7, heads * dh)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    got = tref.rope_ref(torch.from_numpy(x), torch.from_numpy(pos), heads, theta)
    want = jref.rope_ref(jnp.asarray(x), jnp.asarray(pos), heads, theta)
    _close(got, want)


def test_rope_ref_bf16_matches_jax():
    rng = np.random.default_rng(9)
    xj, xt = _bf16_pair(_arr(rng, 3, 5, 4 * 32))
    pos = rng.integers(0, 50, (3, 5)).astype(np.int32)
    got = tref.rope_ref(xt, torch.from_numpy(pos), 4, 1e6)
    want = jref.rope_ref(xj, jnp.asarray(pos), 4, 1e6)
    assert got.dtype == torch.bfloat16
    _close_bf16(got, want)


@pytest.mark.parametrize("steps", [
    (("add", 0), ("norm_rms", 0, 1e-6)),
    (("norm_rms", 0, 1e-5), ("activation", "silu")),
    (("rope", 1, 4, 1e6),),
    (("add", 0), ("rope", 1, 2, 1e4), ("mul", 0)),
], ids=["add-rms", "rms-silu", "rope", "add-rope-mul"])
def test_apply_steps_ref_decoder_steps_match_jax(steps):
    rng = np.random.default_rng(10)
    y = _arr(rng, 2, 6, 128)
    side = _arr(rng, 2, 6, 128)
    pos = rng.integers(0, 40, (2, 6)).astype(np.int32)
    scale = rng.uniform(0.5, 1.5, 128).astype(np.float32)
    got = tref.apply_steps_ref(torch.from_numpy(y), steps,
                               [torch.from_numpy(side), torch.from_numpy(pos)],
                               [(torch.from_numpy(scale), None)])
    want = jref.apply_steps_ref(jnp.asarray(y), steps, [jnp.asarray(side), jnp.asarray(pos)],
                                [(jnp.asarray(scale), None)])
    _close(got, want)


def test_norm_rms_step_bf16_casts_before_the_scale():
    """``norm_rms`` rounds the normalized value to the input's type before
    the scale multiply -- in bf16 that is a rounding of its own."""
    rng = np.random.default_rng(11)
    (yj, yt), (sj, st) = _bf16_pair(_arr(rng, 4, 64)), _bf16_pair(
        rng.uniform(0.5, 1.5, 64).astype(np.float32))
    steps = (("norm_rms", 0, 1e-6),)
    got = tref.apply_steps_ref(yt, steps, [], [(st, None)])
    want = jref.apply_steps_ref(yj, steps, [], [(sj, None)])
    assert got.dtype == torch.bfloat16
    _close_bf16(got, want)


# --------------------------------------------------------------------------- #
# dense matmul in bf16                                                         #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("m,k,n,epi", [
    (3, 128, 64, ()), (3, 128, 96, (("add", 0),)), (37, 70, 50, (("add", 0),)),
    (16, 256, 128, (("activation", "silu"),)),
])
def test_dense_matmul_plain_bf16_matches_jax(m, k, n, epi):
    rng = np.random.default_rng(12)
    (xj, xt), (wj, wt), (bj, bt), (sj, st) = (
        _bf16_pair(_arr(rng, m, k)), _bf16_pair(_arr(rng, k, n, scale=k ** -0.5)),
        _bf16_pair(_arr(rng, n, scale=0.1)), _bf16_pair(_arr(rng, m, n)),
    )
    sides_j = [sj] if any(s[0] == "add" for s in epi) else []
    sides_t = [st] if sides_j else []
    want = jops.matmul(xj, wj, bj, epilogue=epi, epilogue_sides=sides_j)
    got = tops.matmul(xt, wt, bt, epilogue=epi, epilogue_sides=sides_t)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close_bf16(got, want)
    plain = tdense.dense_matmul_plain(xt, wt, bt, *sides_t, epilogue=epi)
    assert torch.equal(got, plain)


def test_dense_matmul_bf16_counts_nothing_on_cpu_and_refuses_other_devices():
    x, w = torch.zeros(3, 8, dtype=torch.bfloat16), torch.zeros(8, 4, dtype=torch.bfloat16)
    tops.reset_kernel_launches()
    assert tdense.dense_matmul(x, w).dtype == torch.bfloat16
    assert tops.dense_dtype_launch_counts() == {"f32": 0, "bf16": 0}
    with pytest.raises(ValueError, match="no kernel for device"):
        tdense.dense_matmul(x.to("meta"), w.to("meta"))
