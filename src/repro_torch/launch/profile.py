"""Plan profiler launcher: where does the millisecond go, per step, on the
host and on the card (a port of ``repro.launch.profile``).

Compiles one of the paper's demo apps through the full pipeline (masks ->
PassManager -> execution plan, optionally calibrated + quantized to INT8),
runs it under :func:`repro_torch.obs.profile.profile_plan`, and prints the
per-step cost table -- host ms (the enqueue), device ms (CUDA events between
the steps, with the card's queue kept ahead of the host), shares of each
total, estimated bytes moved, kernel-vs-reference attribution.

    python -m repro_torch.launch.profile --graph-app style_transfer \\
        --size 256 --base 32 --batch 4 --trace-out build/trace.json
    python -m repro_torch.launch.profile --graph-app coloring --quantize \\
        --runs 5 --json-out build/profile.json
    python -m repro_torch.launch.profile --graph-app super_resolution \\
        --device cpu --size 32 --base 8          # plain versions, host ms only

The backend is ``kernel`` (``quant`` with ``--quantize``) on every device;
on the CPU the kernels' plain versions run, as everywhere in the port, and
the device columns read ``n/a``.  ``--device`` defaults to ``cuda`` (raises
without a GPU).  Load ``--trace-out`` files at https://ui.perfetto.dev (or
``chrome://tracing``): one ``cat="plan"`` span per run, one ``cat="step"``
span per plan step nested under it.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..convert import resolve_device
from ..core.graph import PassContext, PassManager, compile_plan
from ..models.cnn import APP_INPUT_CHANNELS, APPS, app_masks

__all__ = ["build_app_plan", "main"]


def build_app_plan(args, dev: torch.device):
    """The shared demo-app build path (the pipeline of ``launch/serve.py``):
    returns ``(plan, params, input_shape)`` for ``args.graph_app`` on
    ``dev``."""
    from .serve import quantize_app

    g = APPS[args.graph_app](torch.Generator().manual_seed(args.seed), base=args.base, device=dev)
    masks, structures = app_masks(g, args.graph_app, sparsity=args.sparsity)
    go = PassManager().run(g, PassContext(masks=masks, structures=structures))
    shape = (args.batch, APP_INPUT_CHANNELS[args.graph_app], args.size, args.size)
    backend = args.backend or ("quant" if args.quantize else "kernel")
    if args.quantize:
        go = quantize_app(args, go, dev, shape, np.random.default_rng(args.seed))
    return compile_plan(go, backend=backend, device=dev), go.params, shape


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph-app", choices=sorted(APPS), required=True,
                    help="demo app to profile")
    ap.add_argument("--quantize", action="store_true",
                    help="calibrate + quantize the plan to INT8 first")
    ap.add_argument("--backend", default=None,
                    choices=["kernel", "reference", "quant", "guarded"],
                    help="override the backend (kernel, or quant with --quantize)")
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--size", type=int, default=64, help="frame size")
    ap.add_argument("--base", type=int, default=16, help="channel width")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--runs", type=int, default=3,
                    help="traced executions; per-step ms is their median")
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--top", type=int, default=None, help="print only the N hottest steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calib-batches", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    ap.add_argument("--trace-out", default=None,
                    help="write the (last traced run's) Chrome-trace JSON here -- loadable "
                         "in Perfetto / chrome://tracing")
    ap.add_argument("--json-out", default=None,
                    help="write the per-step profile table as JSON here")
    return ap


def main(argv=None):
    """Run the CLI; returns the :class:`PlanProfile`."""
    from ..obs import profile_plan

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":  # the plan tolerances assume true f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    plan, params, shape = build_app_plan(args, dev)
    x = torch.from_numpy(
        np.random.default_rng(args.seed).standard_normal(shape).astype(np.float32))
    prof = profile_plan(plan, params, x, runs=args.runs, warmup=args.warmup)
    print(f"{args.graph_app}: {shape[0]}x{shape[2]}x{shape[3]} "
          f"sparsity={args.sparsity} quantize={args.quantize}")
    print(prof.render_text(top=args.top))
    if prof.total_device_ms is not None:  # the same rows, hottest on the card first
        print("by device ms:")
        print(prof.render_text(top=args.top or 5, by="device").split("\n", 1)[1])
    mem = prof.memory
    print(f"memory: peak_act={mem['peak_activation_bytes'] / 1e6:.2f}MB "
          f"params={mem['param_bytes'] / 1e6:.2f}MB "
          f"saved={mem['weight_bytes_saved'] / 1e6:.2f}MB")
    if args.trace_out:
        print(f"trace: {prof.trace.save(args.trace_out)} "
              f"({len(prof.trace.events)} events; load in Perfetto)")
    if args.json_out:
        print(f"profile json: {prof.save_json(args.json_out)}")
    return prof


if __name__ == "__main__":
    main()
