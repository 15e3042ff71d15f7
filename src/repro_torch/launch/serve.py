"""Serve one of the paper's demo apps through the port's plan compiler.

    python -m repro_torch.launch.serve --graph-app super_resolution \\
        --size 256 --base 32 --frames 10 --batch-size 4

Builds the app (weights from ``--seed``), prunes it with the paper's recipe
(``app_masks``), compiles it with ``PassManager`` + ``compile_plan``
(kernel backend), then serves ``--frames`` frames of ``--size`` x ``--size``
and prints the pass summary, the plan's stats and the speed:

* with ``--batch-size``: throughput mode -- the frames queue up in a
  ``PlanServer`` and run in fixed-size batches (tail batch padded);
  prints frames/s and ms/frame;
* without it: latency mode -- one frame per plan call, ``--frames`` calls;
  prints the median ms/frame.

``--device`` defaults to ``cuda`` (raises without a GPU); ``--device cpu``
runs the kernels' plain PyTorch versions.  Unlike the JAX package's CLI,
``--frames`` counts frames, not batches.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from ..convert import resolve_device
from ..core.graph import PassContext, PassManager, compile_plan
from ..models.cnn import APP_INPUT_CHANNELS, APPS, app_masks
from ..serving.engine import PlanServer

__all__ = ["main", "serve_graph_app"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_graph_app(args) -> dict:
    """Compile ``args.graph_app`` through the full pipeline and serve frames
    through the plan; returns the numbers it prints."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":  # the plan tolerances assume true f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    g = APPS[args.graph_app](torch.Generator().manual_seed(args.seed), base=args.base, device=dev)
    masks, structures = app_masks(g, args.graph_app, sparsity=args.sparsity)
    ctx = PassContext(masks=masks, structures=structures)
    pm = PassManager()
    go = pm.run(g, ctx)
    print(pm.summary(ctx))

    plan = compile_plan(go, backend="kernel", device=dev)
    c_in = APP_INPUT_CHANNELS[args.graph_app]
    batch = args.batch_size or 1
    mem = plan.memory_estimate((batch, c_in, args.size, args.size))
    print(
        f"plan: backend=kernel device={dev} steps={len(plan.steps)} "
        f"peak_act@batch{batch}={mem['peak_activation_bytes'] / 1e6:.2f}MB "
        f"params={mem['param_bytes'] / 1e6:.2f}MB"
    )
    rng = np.random.default_rng(args.seed)
    frames = torch.from_numpy(
        rng.standard_normal((args.frames, c_in, args.size, args.size)).astype(np.float32)
    ).to(dev)
    report = {"app": args.graph_app, "device": str(dev), "steps": len(plan.steps)}

    if args.batch_size is not None:
        server = PlanServer(plan, go.params, args.batch_size, name=args.graph_app)
        server.submit(frames[0])  # warm-up: allocator and first launches
        server.flush()
        _sync(dev)
        server.stats = {k: 0 for k in server.stats}
        t0 = time.perf_counter()
        for f in frames:
            server.submit(f)
        server.flush()
        _sync(dev)
        dt = time.perf_counter() - t0
        s = server.stats
        report.update(frames=s["frames"], seconds=dt, frames_per_s=s["frames"] / dt,
                      ms_per_frame=dt / s["frames"] * 1e3)
        print(
            f"{args.graph_app}: {s['frames']} frames in {dt:.4f}s "
            f"({report['frames_per_s']:.1f} frames/s, {report['ms_per_frame']:.3f} ms/frame) "
            f"over {s['batches']} batches of {args.batch_size} ({s['padded_frames']} padded)"
        )
        return report

    x = frames[:1]
    plan(go.params, x)  # warm-up
    _sync(dev)
    times = []
    for i in range(args.frames):
        x = frames[i : i + 1]
        t0 = time.perf_counter()
        plan(go.params, x)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    report.update(ms_per_frame=ms)
    print(f"{args.graph_app}: {ms:.3f} ms/frame over {args.frames} frames "
          f"(1x{args.size}x{args.size}, sparsity {args.sparsity})")
    return report


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph-app", required=True, choices=sorted(APPS),
                    help="the demo app to compile and serve")
    ap.add_argument("--size", type=int, default=64, help="frame height and width")
    ap.add_argument("--base", type=int, default=16, help="channel width of the app")
    ap.add_argument("--frames", type=int, default=3, help="frames to serve")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="throughput mode: serve through PlanServer in batches of this size")
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap


def main(argv=None) -> dict:
    return serve_graph_app(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
