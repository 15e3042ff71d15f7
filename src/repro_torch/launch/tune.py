"""Tuning-cache pre-warm CLI (a port of ``repro.launch.tune``).

Builds a demo app's graph, runs it through the full pass pipeline, and
executes the resulting plans eagerly with tuning enabled, so every kernel
block-size key reachable from the plan -- the ``matmul`` / ``qmatmul`` /
``conv2d`` families sweep, ``fused_elementwise`` records its one
configuration -- lands in a JSON :class:`~repro_torch.kernels.ops.
TuningCache`.  Ship the JSON to serving via ``REPRO_TUNE_CACHE=path`` and
every plan starts on measured winners instead of the default tiles.

On the card the sweeps time the CUDA kernels (keys end in ``|sm90`` on an
H100); with ``--device cpu`` they time the plain PyTorch versions (keys
end in ``|cpu``) -- useful only to exercise the full path in CI, with
``--smoke``.

Examples::

  python -m repro_torch.launch.tune --graph-app style_transfer \\
      --out build/tuning_style.json
  python -m repro_torch.launch.tune --graph-app all --quantize --size 256 \\
      --base 32 --batch 4                    # the shapes chip_smoke.py serves
  python -m repro_torch.launch.tune --device cpu --smoke --graph-app coloring \\
      --ops conv2d,qmatmul                   # CPU, two key families

Differences from the JAX CLI: ``--device`` (default ``cuda``, raises
without a GPU; ``cpu`` must be asked for), weights from a seeded
``torch.Generator`` as ``launch/serve.py`` draws them, and the default
``--out`` is ``build/tuning_cache.json`` (the JAX CLI writes under
``results/``, a directory of the JAX package).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..convert import resolve_device
from ..kernels import ops as kops

__all__ = ["main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sweep_app(app: str, args, dev: torch.device) -> None:
    """Compile ``app`` and execute its plan(s) eagerly so every reachable
    kernel call resolves -- and therefore sweeps -- its tuning key."""
    from ..core.graph import PassContext, PassManager, compile_plan
    from ..models.cnn import APP_ACT_SKIP, APP_INPUT_CHANNELS, APP_QUANT_SKIP, APPS, app_masks
    from ..quant import calibrate_plan

    g = APPS[app](torch.Generator().manual_seed(args.seed), base=args.base, device=dev)
    masks, structures = app_masks(g, app, sparsity=args.sparsity)
    go = PassManager().run(g, PassContext(masks=masks, structures=structures))
    shape = (args.batch, APP_INPUT_CHANNELS[app], args.size, args.size)
    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    plan = compile_plan(go, backend="kernel", device=dev)
    plan(go.params, x)  # f32 matmul / conv / ew keys
    _sync(dev)
    n_keys = len(kops.tuning_cache().entries)
    print(f"{app}: kernel plan swept ({len(plan.steps)} steps, {n_keys} cache keys so far)")

    if args.quantize:
        plan_ref = compile_plan(go, backend="reference", device=dev)
        table = calibrate_plan(plan_ref, go.params, [x])
        gq = PassManager(("quantize",)).run(
            go,
            PassContext(
                calibration=table, quant_skip=APP_QUANT_SKIP[app],
                act_quant_skip=APP_ACT_SKIP[app],
            ),
        )
        plan_q = compile_plan(gq, backend="quant", device=dev)
        plan_q(gq.params, x)  # qmatmul / int8 conv keys
        _sync(dev)
        print(f"{app}: quant plan swept ({len(kops.tuning_cache().entries)} cache keys so far)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graph-app",
                    choices=["style_transfer", "coloring", "super_resolution", "all"],
                    default="all", help="demo app whose plan keys to pre-warm")
    ap.add_argument("--size", type=int, default=64, help="frame size")
    ap.add_argument("--base", type=int, default=16, help="channel width")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quantize", action="store_true",
                    help="also sweep the INT8 plan (qmatmul / int8 conv keys)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes for CPU/CI")
    ap.add_argument("--ops", default=None,
                    help="comma-separated key families to sweep (e.g. "
                         "'conv2d,qmatmul'); other families resolve to "
                         "defaults without sweeping")
    ap.add_argument("--out", default=None,
                    help="cache JSON path (default: REPRO_TUNE_CACHE or "
                         "build/tuning_cache.json)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.size, args.base = min(args.size, 16), min(args.base, 8)
    dev = resolve_device(args.device)
    if dev.type == "cuda":  # the kernels compute in true f32; so do the references
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    cache = kops.tuning_cache()
    cache.enabled = True
    if args.ops:
        cache.ops_filter = frozenset(
            op.strip() for op in args.ops.split(",") if op.strip()
        )
    apps = (
        ["style_transfer", "coloring", "super_resolution"]
        if args.graph_app == "all" else [args.graph_app]
    )
    for app in apps:
        _sweep_app(app, args, dev)

    print(cache.report())
    print(cache.stats_report())
    out = args.out or os.environ.get("REPRO_TUNE_CACHE") or os.path.join(
        "build", "tuning_cache.json"
    )
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    print(f"tune: {cache.sweeps} sweeps, {len(cache.entries)} keys -> {cache.save(out)}")


if __name__ == "__main__":
    main()
