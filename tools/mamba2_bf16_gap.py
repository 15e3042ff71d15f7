#!/usr/bin/env python3
"""Mamba-2's chunked ``forward`` against its step recurrence, in both packages,
at mamba2-1.3b's full width (depth cut), on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/mamba2_bf16_gap.py [--layers 4] [--seq 16]

One numpy param tree (seeded, the JAX package's ``init_lm`` layout) goes
into both packages.  For bf16 and f32, each package runs ``forward`` over
``--seq`` tokens and, separately, prefill of the first token and one
``decode_step`` a token after it; the script prints the largest logit gap
between the two forms (the teacher-forced rows the greedy-parity probe
reads).  The JAX package runs jitted twice: as XLA compiles it by default
(it may keep a fused bf16 intermediate in f32 across a cast) and with
``xla_allow_excess_precision`` off (every cast rounded where the code puts
it).  It also prints the port's largest logit difference from the strict
JAX package on each form.

The chunked and recurrent forms sum the same f32 products in other orders
and round each layer's output to bf16, so in bf16 their logits part by
ulps that grow with depth; this script shows the reference doing it.  It
imports both packages, so it lives outside the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import transformer as jlm
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import transformer as tlm

STRICT = {"xla_allow_excess_precision": False}


def numpy_params(shapes, seed):
    """Weights ~ N(0, 1/fan_in), norm scales in [0.5, 1.5], the SSM leaves in
    their init's ranges, in the layout (shapes and dtypes) of ``shapes``."""
    rng = np.random.default_rng(seed)

    def leaf(key, sd):
        shape, dt = tuple(sd.shape), np.dtype(sd.dtype)
        if key in ("scale", "D"):
            a = rng.uniform(0.5, 1.5, shape)
        elif key in ("bias", "b", "dt_bias"):
            a = rng.standard_normal(shape) * 0.1
        elif key == "A_log":
            a = np.log(rng.uniform(1.0, 16.0, shape))
        elif key == "table":
            a = rng.standard_normal(shape) * 0.5
        else:
            a = rng.standard_normal(shape) / np.sqrt(shape[-2])
        return a.astype(dt)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, key) for v in node)
        return leaf(key, node)

    return walk(shapes)


def as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def two_forms(forward, prefill, decode_step, tok, v):
    """(forward's logits, the recurrence's logits), real classes only."""
    full = as_f32(forward(tok))[..., :v]
    logits, caches = prefill(tok[:, :1])
    rows = [as_f32(logits)[..., :v]]
    for t in range(1, tok.shape[1]):
        logits, caches = decode_step(tok[:, t:t + 1], caches)
        rows.append(as_f32(logits)[..., :v])
    return full, np.concatenate(rows, 1)


def jax_forms(jp, jcfg, tok, opts):
    fwd = jax.jit(jlm.forward, static_argnums=1, compiler_options=opts)
    pre = jax.jit(jlm.prefill, static_argnums=(1, 3), compiler_options=opts)
    step = jax.jit(jlm.decode_step, static_argnums=1, compiler_options=opts)
    return two_forms(lambda t: fwd(jp, jcfg, jnp.asarray(t))[0],
                     lambda t: pre(jp, jcfg, jnp.asarray(t), tok.shape[1]),
                     lambda t, cs: step(jp, jcfg, jnp.asarray(t), cs), tok, jcfg.vocab)


def port_forms(tp, cfg, tok):
    with torch.no_grad():
        return two_forms(lambda t: tlm.forward(tp, cfg, torch.from_numpy(t))[0],
                         lambda t: tlm.prefill(tp, cfg, torch.from_numpy(t), tok.shape[1]),
                         lambda t, cs: tlm.decode_step(tp, cfg, torch.from_numpy(t), cs),
                         tok, cfg.vocab)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4, help="mamba2-1.3b's 48 layers cut to this")
    ap.add_argument("--seq", type=int, default=16, help="tokens a row (2 rows)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    report = {}
    for dtype in ("bfloat16", "float32"):
        jcfg = dataclasses.replace(jget_config("mamba2-1.3b"), n_layers=args.layers, dtype=dtype)
        cfg = dataclasses.replace(get_config("mamba2-1.3b"), n_layers=args.layers, dtype=dtype)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        pnp = numpy_params(jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), jcfg)),
                           args.seed)
        jp = jax.tree_util.tree_map(jnp.asarray, pnp)
        tp = lm_params_from_numpy(pnp, device="cpu")
        tok = np.random.default_rng(args.seed + 1).integers(
            0, cfg.vocab, (2, args.seq)).astype(np.int32)
        t0 = time.perf_counter()
        forms = {"jax (default XLA)": jax_forms(jp, jcfg, tok, None),
                 "jax (strict casts)": jax_forms(jp, jcfg, tok, STRICT),
                 "port": port_forms(tp, cfg, tok)}
        top = float(np.abs(forms["jax (strict casts)"][0]).max())
        print(f"mamba2-1.3b width, {args.layers} layers, {dtype}, 2 x {args.seq} tokens "
              f"(max |logit| {top:.4f}; {time.perf_counter() - t0:.1f}s):")
        for name, (full, steps) in forms.items():
            gap = float(np.abs(full - steps).max())
            report[(dtype, name)] = gap
            print(f"  {name:20s} max |forward - recurrence| = {gap:.6g}")
        sf, ss = forms["jax (strict casts)"]
        pf, ps = forms["port"]
        print(f"  port vs strict jax: forward {float(np.abs(pf - sf).max()):.6g}, "
              f"recurrence {float(np.abs(ps - ss).max()):.6g}")
        report[(dtype, "port vs strict")] = (float(np.abs(pf - sf).max()),
                                             float(np.abs(ps - ss).max()))
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
