#!/usr/bin/env python3
"""Drive the PyTorch/Hopper port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own lines):

1. device  -- the card's name and power limit, as nvidia-smi reports them;
2. build   -- compile ``src/repro_torch/kernels/csrc/*.cu`` (or find them
              built) into ``build/repro_torch_kernels/``;
3. kernels -- each CUDA kernel against its plain PyTorch version on the card,
              at the main path's shapes and ragged ones: max error; device
              ms per call (profiler kernel time) of the kernel, the plain
              version and the library call; the kernel's per-call time as
              the stream sees it (``call_ms``, host launch overhead
              included); and the least time the card could take (bytes over
              3.35 TB/s or FLOPs over 67 TFLOP/s, the H100 SXM's memory rate
              and f32 CUDA-core peak);
4. apps    -- the paper's pipeline for each demo app at full width (base 32):
              build from a seeded ``torch.Generator``, prune with
              ``app_masks``, compile with ``PassManager`` + ``compile_plan``,
              serve 10 frames of 256x256 through ``PlanServer(batch_size=4)``;
              checks the node count, the exact kernel launches per plan call,
              zero conv fallbacks, and the output against the reference plan;
              then profiles one more serving run (device time per kernel
              family and the device's idle share).

The line before the last is a JSON object with every kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.  Any failed check raises, and
the script exits non-zero.  Without a CUDA device, or without the
repository's ``src/repro_torch`` beside it, it exits non-zero and prints no
result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32 FMA rate on
#: the CUDA cores (no tensor cores: the kernels compute in true f32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

SEED = 0
BASE = 32
SIZE = 256
FRAMES = 10
BATCH = 4
TIMING_REPS = 3

#: per plan call: (plan nodes, conv2d launches, dense_matmul launches,
#: fused_elementwise launches)
EXPECTED = {
    "style_transfer": (18, 11, 5, 0),
    "coloring": (19, 12, 2, 0),
    "super_resolution": (20, 10, 8, 1),
}

#: where each kernel lives and which TPU kernel it replaces
KERNELS = {
    "conv2d": ("src/repro_torch/kernels/csrc/conv2d.cu", "src/repro/kernels/conv2d.py:175"),
    "dense_matmul": (
        "src/repro_torch/kernels/csrc/dense_matmul.cu", "src/repro/kernels/dense_matmul.py:85",
    ),
    "fused_elementwise": (
        "src/repro_torch/kernels/csrc/fused_elementwise.cu",
        "src/repro/kernels/fused_elementwise.py:39",
    ),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def device_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the time of every kernel it
    launches, from torch.profiler, averaged over ``reps`` calls (host work
    between launches is not counted)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    check(us > 0, "the profiler saw no device time")
    return us / reps / 1e3


def call_ms(torch, fn, reps: int = 20) -> float:
    """Time of one call of ``fn`` as the stream sees it: CUDA events around
    ``reps`` back-to-back calls (includes the host's launch overhead when
    the host is slower than the device)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    dt = time.perf_counter() - t0
    print(f"build: {dt:.1f}s -> {path.relative_to(ROOT)}")
    log = (path.parent / "build.log").read_text()
    for line in log.splitlines():
        if "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())


def phase_kernels(torch):
    """Every kernel against its plain version at the main path's shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels import dense_matmul as kdense
    from repro_torch.kernels import fused_elementwise as kfused
    from repro_torch.kernels.ref import _ACT, xla_conv_pads

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    results = {name: [] for name in KERNELS}

    def record(name, label, out, want, kernel, plain, library, nb, flops):
        err = (out - want).abs().max().item()
        tol = 1e-4 * max(1.0, want.abs().max().item())
        b_ms, b_by = bound(nb, flops)
        ms, plain_ms = device_ms(torch, kernel), device_ms(torch, plain, reps=5)
        library_ms = None if library is None else device_ms(torch, library)
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        print(f"  {name:18s} {label:42s} max_err={err:.3e} (tol {tol:.1e}) "
              f"ms={ms:.4f} call_ms={call_ms(torch, kernel):.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib} bound_ms={b_ms:.4f} ({b_by})")
        check(err <= tol, f"{name} {label}: max_err {err} > {tol}")
        results[name].append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  library_ms=library_ms, bound_ms=b_ms, bound_by=b_by))

    # -- conv2d -------------------------------------------------------------- #
    def conv_case(label, n, c_in, hw, o, k, stride, c_live=None, act=None, add_side=False):
        h, w_ = hw
        x = randn(n, c_in, h, w_)
        c = c_live or c_in
        kept = None
        if c_live:
            kept = torch.sort(torch.randperm(c_in, generator=gen, device=dev)[:c_live]).values
            kept = kept.to(torch.int32)
        wt = randn(o, c, k, k, scale=(c * k * k) ** -0.5)
        b = randn(o, scale=0.1)
        oh, ow = kconv.conv_out_hw(h, w_, k, k, stride, "SAME")
        sides = (randn(n, o, oh, ow),) if add_side else ()
        epi = (("add", 0),) if add_side else ()
        kw = dict(kept=kept, stride=stride, padding="SAME", activation=act, epilogue=epi)
        out = kconv.conv2d_gemm(x, wt, b, *sides, **kw)
        want = kconv.conv2d_plain(x, wt, b, *sides, **kw)
        # library yardstick: cuDNN on the gathered, XLA-padded input (the
        # gather and the asymmetric pad are prepared outside the timing)
        xg = x if kept is None else x.index_select(1, kept)
        ph = xla_conv_pads(h, k, stride, "SAME", 0)
        pw = xla_conv_pads(w_, k, stride, "SAME", 1)
        xp = F.pad(xg, (pw[0], pw[1], ph[0], ph[1]))

        def library():
            y = _ACT[act](F.conv2d(xp, wt, b, stride=stride))
            return y + sides[0] if add_side else y

        nb = nbytes(xg, wt, b, kept, *sides, out)
        flops = 2.0 * n * oh * ow * o * c * k * k
        record("conv2d", label, out, want, lambda: kconv.conv2d_gemm(x, wt, b, *sides, **kw),
               lambda: kconv.conv2d_plain(x, wt, b, *sides, **kw), library, nb, flops)

    conv_case("7x7 s1 3->32 @256^2 n4", BATCH, 3, (SIZE, SIZE), BASE, 7, 1)
    conv_case("3x3 s2 16-of-32->64 @256^2 n4", BATCH, 32, (SIZE, SIZE), 64, 3, 2, c_live=16)
    conv_case("3x3 s1 96-of-192->32 +add @256^2 n4", BATCH, 192, (SIZE, SIZE), 32, 3, 1,
              c_live=96, add_side=True)
    conv_case("3x3 s1 8-of-16->2 tanh @256^2 n4", BATCH, 16, (SIZE, SIZE), 2, 3, 1,
              c_live=8, act="tanh")
    conv_case("3x3 s2 24->40 relu @37x29 n2", 2, 24, (37, 29), 40, 3, 2, act="relu")

    # -- dense_matmul -------------------------------------------------------- #
    def dense_case(label, m, k, n, act=None, sides_epi=False):
        x = randn(m, k)
        wt = randn(k, n, scale=k ** -0.5)
        b = randn(n, scale=0.1)
        sides = (randn(m, n), randn(m, n)) if sides_epi else ()
        epi = (("add", 0), ("mul", 1)) if sides_epi else ()
        kw = dict(activation=act, epilogue=epi)
        out = kdense.dense_matmul(x, wt, b, *sides, **kw)
        want = kdense.dense_matmul_plain(x, wt, b, *sides, **kw)

        def library():
            y = _ACT[act](torch.addmm(b, x, wt))
            return (y + sides[0]) * sides[1] if sides_epi else y

        record("dense_matmul", label, out, want,
               lambda: kdense.dense_matmul(x, wt, b, *sides, **kw),
               lambda: kdense.dense_matmul_plain(x, wt, b, *sides, **kw), library,
               nbytes(x, wt, b, *sides, out), 2.0 * m * n * k)

    dense_case("M=4*256^2 K=32 N=192 relu", BATCH * SIZE * SIZE, BASE, 6 * BASE, act="relu")
    dense_case("M=4 K=64 N=64", BATCH, 2 * BASE, 2 * BASE)
    dense_case("M=1000 K=50 N=70 add+mul", 1000, 50, 70, sides_epi=True)

    # -- fused_elementwise --------------------------------------------------- #
    def fused_case(label, m, d, steps, n_sides, n_norms):
        x = randn(m, d)
        sides = [randn(m, d) for _ in range(n_sides)]
        norms = [(randn(d, scale=0.1) + 1.0, randn(d, scale=0.1)) for _ in range(n_norms)]
        out = kfused.fused_elementwise(x, sides, steps, norms)
        want = kfused.fused_elementwise_plain(x, sides, steps, norms)
        flops = float(m * d * sum(8 if s[0] == "norm" else 1 for s in steps))
        nb = nbytes(x, *sides, *[t for pair in norms for t in pair], out)
        record("fused_elementwise", label, out, want,
               lambda: kfused.fused_elementwise(x, sides, steps, norms),
               lambda: kfused.fused_elementwise_plain(x, sides, steps, norms), None, nb, flops)

    fused_case("[4,32,256,256] add,add", BATCH * BASE * SIZE, SIZE,
               (("add", 0), ("add", 1)), 2, 0)
    fused_case("[333,200] add,norm,gelu,mul", 333, 200,
               (("add", 0), ("norm", 0, 1e-5), ("activation", "gelu"), ("mul", 1)), 2, 1)
    torch.cuda.synchronize()
    return results


def phase_apps(torch, np):
    from repro_torch.core.graph import PassContext, PassManager, compile_plan
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import APP_INPUT_CHANNELS, APPS, app_masks
    from repro_torch.serving import PlanServer

    launches = {name: 0 for name in KERNELS}
    rng = np.random.default_rng(SEED)
    for app, (n_nodes, n_conv, n_dense, n_fused) in EXPECTED.items():
        g = APPS[app](torch.Generator().manual_seed(SEED), base=BASE, device="cuda")
        masks, structures = app_masks(g, app, sparsity=0.5)
        ctx = PassContext(masks=masks, structures=structures)
        go = PassManager().run(g, ctx)
        check(len(go.nodes) == n_nodes, f"{app}: {len(go.nodes)} plan nodes, want {n_nodes}")
        plan = compile_plan(go, backend="kernel", device="cuda")
        ref_plan = compile_plan(go, backend="reference", device="cuda")
        c_in = APP_INPUT_CHANNELS[app]
        frames = torch.from_numpy(
            rng.standard_normal((FRAMES, c_in, SIZE, SIZE)).astype(np.float32)
        ).to("cuda")
        mem = plan.memory_estimate((BATCH, c_in, SIZE, SIZE))

        def serve():
            server = PlanServer(plan, go.params, BATCH, name=app)
            for f in frames:
                server.submit(f)
            out = server.close()
            torch.cuda.synchronize()
            return out, server.stats

        serve()  # warm-up: allocator, first launches
        ops.reset_kernel_launches()
        ops.reset_conv_fallbacks()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(TIMING_REPS):
            t0 = time.perf_counter()
            out, stats = serve()
            times.append(time.perf_counter() - t0)
        counts = ops.kernel_launch_counts()
        fallbacks = ops.conv_fallback_counts()
        peak = torch.cuda.max_memory_allocated()
        calls = stats["batches"] * TIMING_REPS
        check(stats["batches"] == 3 and stats["padded_frames"] == 2,
              f"{app}: served {stats}, want 3 chunks with 2 padded frames")
        for name, want in (("conv2d", n_conv), ("dense_matmul", n_dense),
                           ("fused_elementwise", n_fused)):
            check(counts[name] == want * calls,
                  f"{app}: {name} launched {counts[name]} times over {calls} plan calls, "
                  f"want {want} per call")
            launches[name] += counts[name]
        check(sum(fallbacks.values()) == 0, f"{app}: conv fallbacks {fallbacks}")
        want = torch.cat(
            [ref_plan(go.params, frames[i:i + BATCH]) for i in range(0, FRAMES, BATCH)]
        )
        check(tuple(out.shape) == tuple(want.shape), f"{app}: shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{app}: non-finite output")
        err = (out - want).abs().max().item()
        tol = 1e-3 * max(1.0, want.abs().max().item())
        check(err <= tol, f"{app}: max|kernel plan - reference plan| {err} > {tol}")
        sec = statistics.median(times)
        print(f"  {app:16s} nodes={len(go.nodes)} per-call launches conv2d={n_conv} "
              f"dense_matmul={n_dense} fused_elementwise={n_fused} fallbacks=0 "
              f"out={tuple(out.shape)} max_err={err:.3e} (tol {tol:.1e}) "
              f"ms/frame={sec / FRAMES * 1e3:.3f} frames/s={FRAMES / sec:.1f} "
              f"(median of {TIMING_REPS} x {FRAMES} frames) "
              f"peak_alloc={peak / 1e6:.1f}MB est_peak_act@batch{BATCH}="
              f"{mem['peak_activation_bytes'] / 1e6:.1f}MB")
        profile_serving(torch, app, serve)
    return launches


#: kernel-name fragments of the port's own kernels
_OWN = {"conv2d_igemm": "conv2d", "dense_matmul_kernel": "dense_matmul",
        "fused_ew": "fused_elementwise"}


def profile_serving(torch, app, serve):
    """Where one serving run's device time goes (torch.profiler): device
    time per kernel family, and the device's idle share of the wall time
    (inflated by the profiler's own host overhead)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities, acc_events=True) as prof:
        t0 = time.perf_counter()
        serve()
        wall_us = (time.perf_counter() - t0) * 1e6
    by = {}
    for e in prof.key_averages():
        # device-side kernel events only: a host op's entry repeats the
        # device time of the kernels it launched
        us = e.self_device_time_total
        if e.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        name = next((v for k, v in _OWN.items() if k in e.key), None)
        name = name or "other:" + e.key.split("(")[0].split("<")[0][:48]
        by[name] = by.get(name, 0.0) + us
    busy = sum(by.values())
    check(busy > 0, f"{app}: the profiler saw no device time")
    top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
    parts = " ".join(f"{k}={v / 1e3:.3f}ms({v / busy:.0%})" for k, v in top)
    print(f"    profile {app}: device {busy / 1e3:.3f}ms of wall {wall_us / 1e3:.3f}ms "
          f"(idle {1 - busy / wall_us:.0%}) {parts}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== device")
    phase_device(torch)
    print("== build")
    phase_build()
    print("== kernels")
    results = phase_kernels(torch)
    print(f"== apps (base={BASE}, {FRAMES} frames of {SIZE}x{SIZE}, batch {BATCH})")
    launches = phase_apps(torch, np)
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    line = {"kernels": []}
    for name, (source, replaces) in KERNELS.items():
        head = results[name][0]  # the main-path headline case
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in results[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["label"],
        })
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
