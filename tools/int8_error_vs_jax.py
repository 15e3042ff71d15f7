#!/usr/bin/env python3
"""INT8-against-f32 error of both packages' demo apps, on the same arrays.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/int8_error_vs_jax.py [--base 32] [--size 256]

For each demo app: one set of numpy weights (seeded) goes into the JAX
package's graph and the port's; each package prunes and optimizes it with
the app's recipe, calibrates its own f32 reference plan on the same numpy
batches, runs the ``quantize`` pass with the app's skip sets, and runs its
INT8 and f32 plans on the ``reference`` backend (no Pallas, no CUDA: both
on the CPU) over the same numpy frames.  Prints each package's max
|INT8 plan - f32 plan| and the port's excess over the JAX package's.

The chip run's figures (``chip_smoke.py``'s ``== int8 apps`` line) come
from other weights (a torch generator); this script holds the port to the
JAX package on identical inputs at the served shape.  It imports both
packages, so it lives outside the port.
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

from repro.core.graph import PassContext as JPassContext
from repro.core.graph import PassManager as JPassManager
from repro.core.graph import compile_plan as jcompile_plan
from repro.models import cnn as jcnn
from repro.quant import calibrate_plan as jcalibrate_plan
from repro_torch.core.graph import PassContext, PassManager, compile_plan
from repro_torch.models import cnn as tcnn
from repro_torch.quant import CalibrationTable, calibrate_plan

APPS = ("style_transfer", "coloring", "super_resolution")


def numpy_params(g, seed):
    """Weights for every param of ``g`` (fan-in scaled normals; norms'
    scale / var in [0.5, 1.5])."""
    rng = np.random.default_rng(seed)
    out = {}
    for node in g.nodes:
        for key, v in g.params.get(node.name, {}).items():
            shape = tuple(v.shape)
            if key == "w":
                fan = int(np.prod(shape[1:])) if len(shape) == 4 else shape[0]
                arr = rng.standard_normal(shape) / np.sqrt(fan)
            elif key in ("scale", "var"):
                arr = rng.uniform(0.5, 1.5, shape)
            else:
                arr = rng.standard_normal(shape) * 0.1
            out.setdefault(node.name, {})[key] = arr.astype(np.float32)
    return out


def app_errors(app, base, size, batch, seed):
    normal = jax.random.normal  # the JAX builder's own draws are replaced below
    jax.random.normal = lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype)
    try:
        jg = jcnn.APPS[app](jax.random.PRNGKey(0), base=base)
    finally:
        jax.random.normal = normal
    pnp = numpy_params(jg, seed)
    jg = dataclasses.replace(
        jg, params={n: {k: jnp.asarray(v) for k, v in p.items()} for n, p in pnp.items()})
    jmasks, jstructs = jcnn.app_masks(jg, app, sparsity=0.5)
    jgo = JPassManager().run(jg, JPassContext(masks=jmasks, structures=jstructs))
    tg = tcnn.APPS[app](base=base, params=pnp, device="cpu")
    masks, structs = tcnn.app_masks(tg, app, sparsity=0.5)
    tgo = PassManager().run(tg, PassContext(masks=masks, structures=structs))

    rng = np.random.default_rng(seed + 1)
    shape = (batch, tcnn.APP_INPUT_CHANNELS[app], size, size)
    calib = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    frames = rng.standard_normal(shape).astype(np.float32)

    jplan = jcompile_plan(jgo, backend="reference")
    jtable = jcalibrate_plan(jplan, jgo.params, [jnp.asarray(b) for b in calib])
    jgq = JPassManager(("quantize",)).run(jgo, JPassContext(
        calibration=jtable, quant_skip=jcnn.APP_QUANT_SKIP[app],
        act_quant_skip=jcnn.APP_ACT_SKIP[app]))
    jqplan = jcompile_plan(jgq, backend="reference")
    jf32 = np.asarray(jax.jit(jplan)(jgo.params, jnp.asarray(frames)))
    jq = np.asarray(jax.jit(jqplan)(jgq.params, jnp.asarray(frames)))

    with torch.no_grad():
        plan = compile_plan(tgo, backend="reference", device="cpu")
        table = calibrate_plan(plan, tgo.params, [torch.from_numpy(b) for b in calib])
        tgq = PassManager(("quantize",)).run(tgo, PassContext(
            calibration=table, quant_skip=tcnn.APP_QUANT_SKIP[app],
            act_quant_skip=tcnn.APP_ACT_SKIP[app]))
        qplan = compile_plan(tgq, backend="reference", device="cpu")
        tf32 = plan(tgo.params, torch.from_numpy(frames)).numpy()
        tq = qplan(tgq.params, torch.from_numpy(frames)).numpy()
    return dict(jax=float(np.abs(jq - jf32).max()), port=float(np.abs(tq - tf32).max()),
                f32_gap=float(np.abs(tf32 - jf32).max()),
                schemes=sorted({n.attrs["scheme"] for n in tgq.nodes
                                if n.op in ("qconv2d", "qlinear")}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=int, default=32)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--apps", default=",".join(APPS))
    args = ap.parse_args(argv)
    print(f"base {args.base}, {args.batch} frames of {args.size}x{args.size}, "
          f"numpy seed {args.seed}; reference backends on the CPU")
    for app in args.apps.split(","):
        t0 = time.perf_counter()
        e = app_errors(app, args.base, args.size, args.batch, args.seed)
        excess = e["port"] / e["jax"] - 1 if e["jax"] > 0 else float("nan")
        print(f"  {app:16s} schemes={e['schemes']} max|int8 - f32|: jax {e['jax']:.4e} "
              f"port {e['port']:.4e} (port {excess:+.1%} vs jax; f32 plans differ by "
              f"{e['f32_gap']:.2e}) [{time.perf_counter() - t0:.1f}s]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
