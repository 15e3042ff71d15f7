"""The zoo's configs and entry points in the port against the JAX package:
``get_config`` / ``smoke_config`` of all ten ``ARCH_IDS`` are
``dataclasses.asdict``-equal to the JAX package's; no entry point raises
"not ported" (``get_model`` and its caches for every arch; the serve CLI's
default path for a decoder-only zoo arch, a VLM's prefix past
``--max-len``, a MoE arch without the forward probe, whisper's exit,
``--llm``'s refusal of what the decoder lowering does not take; the parity
rule over whisper's teacher-forced logits); and the deterministic
init leaves (Mamba-2's ``A_log`` / ``dt_bias`` / ``D``, RG-LRU's ``lam``)
equal the JAX package's within one f32 ulp.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS as JARCH_IDS
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import smoke_config as jsmoke_config
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.models import get_model, rglru, ssm


def test_arch_ids_are_the_jax_packages():
    assert ARCH_IDS == JARCH_IDS and len(ARCH_IDS) == 10


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_configs_equal_the_jax_package(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(smoke_config(arch)) == dataclasses.asdict(jsmoke_config(arch))


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_get_model_serves_every_arch(arch):
    """``get_model`` builds every arch's smoke model, and one decode step
    runs from its empty caches (an encoder-decoder's with its cross K/V)."""
    cfg = smoke_config(arch)
    model = get_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    caches = model.init_cache(2, 16)
    if cfg.is_encdec:
        from repro_torch.models import encdec

        enc = encdec.encode(params, cfg, torch.zeros(2, 8, cfg.d_model))
        caches = (caches, encdec.precompute_cross_kv(params, cfg, enc))
    logits, _ = model.decode_step(params, {"tokens_t": torch.ones(2, 1, dtype=torch.int32)},
                                  caches)
    assert tuple(logits.shape) == (2, 1, cfg.vocab_padded)
    assert bool(torch.isfinite(logits[..., :cfg.vocab]).all())


def test_serve_default_path_takes_the_zoo():
    rep = tserve.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "6", "--new-tokens", "4"])
    assert rep["tokens"].shape == (2, 4) and rep["parity"]["exact"]
    with pytest.raises(SystemExit, match="encoder-decoder"):
        tserve.main(["--arch", "whisper-small", "--smoke", "--device", "cpu"])


def test_serve_default_path_sizes_the_engine_for_a_vlm_prefix(capsys):
    """paligemma's 16 smoke patches come before an 8-token prompt and 4 new
    tokens: 28 positions, past ``--max-len 16``.  The Engine is built with
    28 slots, so nothing is cut and the served tokens pass the probe
    against ``forward`` over the whole prefix."""
    rep = tserve.main(["--arch", "paligemma-3b", "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--new-tokens", "4", "--max-len", "16",
                       "--scheduler"])
    out = capsys.readouterr().out
    assert smoke_config("paligemma-3b").vision_tokens == 16
    assert "max_len=28" in out and "greedy parity ok" in out
    assert rep["tokens"].shape == (2, 4) and rep["parity"]["exact"]
    assert all(r.done for r in rep["scheduler"])


def test_serve_default_path_serves_moe_without_the_forward_probe(capsys):
    """A MoE model's ``forward`` over prompt + reply drops other token-slots
    than its prefill and one-token steps: the CLI serves it (Engine and
    scheduler) and says it runs no probe against ``forward``."""
    rep = tserve.main(["--arch", "deepseek-v2-lite-16b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "6", "--new-tokens", "4", "--scheduler"])
    out = capsys.readouterr().out
    assert "no greedy-parity probe for a MoE model" in out and "greedy parity ok" not in out
    assert rep["parity"] is None and rep["tokens"].shape == (2, 4)
    assert all(r.done and len(r.generated) == r.max_new for r in rep["scheduler"])


def test_parity_rule_holds_whisper_steps_to_decode_train():
    """``serve.parity_rule`` over teacher-forced logits: whisper's greedy
    ``decode_step`` tokens against ``decode_train`` over the same tokens
    (f32: every token equal, gap 0); a changed token fails it."""
    from repro_torch.models import encdec

    cfg = smoke_config("whisper-small")
    model = get_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    frames = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        enc = encdec.encode(params, cfg, frames)
        state = (model.init_cache(2, 16), encdec.precompute_cross_kv(params, cfg, enc))
        tok, seq = torch.zeros((2, 1), dtype=torch.int32), []
        for _ in range(6):
            logits, state = model.decode_step(params, {"tokens_t": tok}, state)
            tok = logits[:, 0, :cfg.vocab].argmax(-1).to(torch.int32)[:, None]
            seq.append(tok)
        seq = torch.cat([torch.zeros((2, 1), dtype=torch.int32)] + seq, 1)
        forced = encdec.decode_train(params, cfg, seq[:, :-1], enc)[..., :cfg.vocab]
    for row in range(2):
        par = tserve.parity_rule(forced[row], seq[row, 1:].tolist(), bf16=False)
        assert par["exact"] and par["compared"] == 6 and par["max_forced_gap"] == 0.0
    bad = seq[0, 1:].tolist()
    bad[3] = (bad[3] + 1) % cfg.vocab
    with pytest.raises(AssertionError, match="greedy parity"):
        tserve.parity_rule(forced[0], bad, bf16=False)


@pytest.mark.parametrize("arch,msg", [("qwen3-14b", "qk_norm"),
                                      ("deepseek-v2-lite-16b", "MLA"),
                                      ("mamba2-1.3b", "dense GQA"),
                                      ("whisper-small", "enc-dec")])
def test_llm_path_refuses_what_the_lowering_does_not_take(arch, msg):
    """``--llm`` lowers dense GQA decoders only; the others raise the JAX
    lowering's ``NotImplementedError`` before a model is drawn."""
    with pytest.raises(NotImplementedError, match=msg):
        tserve.main(["--llm", "--arch", arch, "--smoke", "--device", "cpu"])


def _ulps(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.numpy() - want) / np.spacing(np.abs(want))))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "smoke"])
def test_mamba2_init_leaves_equal_jax(arch):
    cfg = get_config(arch) if arch != "smoke" else smoke_config("mamba2-1.3b")
    # jitted, only these leaves are computed (the weights' draws are dead code)
    jleaves = jax.jit(lambda: {k: v for k, v in jssm.init_mamba2(
        jax.random.PRNGKey(0), cfg).items() if k in ("A_log", "dt_bias", "D")})()
    h = jleaves["A_log"].shape[0]
    got = ssm.init_mamba2(torch.Generator().manual_seed(0), cfg)
    for k in ("A_log", "dt_bias", "D"):
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == (h,)
    assert _ulps(got["A_log"], jleaves["A_log"]) <= 1.0
    assert torch.equal(got["dt_bias"], torch.zeros(h)) and np.all(np.asarray(jleaves["dt_bias"]) == 0)
    assert torch.equal(got["D"], torch.ones(h)) and np.all(np.asarray(jleaves["D"]) == 1)


@pytest.mark.parametrize("width", [128, 4096])
def test_rglru_lam_equals_jax(width):
    """``lam = log(a / (1 - a))`` for ``a = linspace(0.9, 0.999) ** (1/8)``
    turns one ulp of ``a`` (near 0.9999) into hundreds of ulps of ``lam``:
    the JAX package's own eager and jitted inits differ by up to 124 ulps at
    width 128.  So ``a = sigmoid(lam)``, the gate base the recurrence
    raises, is held within one f32 ulp of the JAX package's, and ``lam``
    within what two ulps of ``a`` move it (its condition number; the second
    ulp covers the f32 roundings between ``a`` and ``lam``)."""
    cfg = dataclasses.replace(smoke_config("recurrentgemma-9b"), d_model=8,
                              recurrent=dataclasses.replace(
                                  smoke_config("recurrentgemma-9b").recurrent, lru_width=width))
    want = np.asarray(jax.jit(lambda: jrglru.init_rglru_block(jax.random.PRNGKey(0), cfg)["lam"])())
    got = rglru.init_rglru_block(torch.Generator().manual_seed(0), cfg)["lam"]
    assert got.dtype == torch.float32 and tuple(got.shape) == (width,)
    def sigmoid(lam):  # in f64, rounded once
        return (1.0 / (1.0 + np.exp(-np.asarray(lam, np.float64)))).astype(np.float32)

    a_want = sigmoid(want)
    assert _ulps(torch.from_numpy(sigmoid(got.numpy())), a_want) <= 1.0
    # d lam / d a = 1 / (a (1 - a)), times two ulps of a
    two_ulps_of_a = 2 * np.spacing(a_want) / (a_want.astype(np.float64) * (1 - a_want))
    assert np.all(np.abs(got.numpy().astype(np.float64) - want) <= two_ulps_of_a)
