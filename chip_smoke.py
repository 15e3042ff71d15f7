#!/usr/bin/env python3
"""Drive the PyTorch/Hopper port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own lines):

1. device  -- the card's name and power limit, as nvidia-smi reports them;
2. build   -- compile ``src/repro_torch/kernels/csrc/*.cu`` (or find them
              built) into ``build/repro_torch_kernels/``; the library's SASS
              (``cuobjdump``) must show HMMA in every bf16 tensor-core GEMM
              and no bf16 instance of the CUDA-core GEMMs;
3. kernels -- each CUDA kernel against its plain PyTorch version on the card,
              at the main path's shapes and ragged ones, the INT8 schemes of
              the conv kernel and both schemes of the quant matmul included,
              the pipelined (K-slab ring) GEMMs at depth 2 and 3 also
              ``torch.equal`` to the tiled kernel, and every tile of each
              kernel family once (``torch.equal`` to the default tile; the
              bf16 GEMM's own tile list on a prefill and an odd-K case);
              every GEMM shape the decoder plans launch, at decode and
              prefill, with a sum of their device ms per plan call:
              max error; device ms per call (profiler kernel time, or CUDA
              events where no profiler session saw device time) of the
              kernel, the plain version and the library call; the kernel's
              per-call time as the stream sees it (``call_ms``, host launch
              overhead included); and the least time the card could take
              (bytes over 3.35 TB/s, or operations over 67 TFLOP/s for f32
              -- the H100 SXM's memory rate and f32 CUDA-core peak -- over
              989 TFLOP/s for bf16, or over 1,979 TOP/s for int8, its
              tensor-core peaks; the block-sparse kernel's cases count the
              real blocks' bytes and operations);
4. apps    -- the paper's pipeline for each demo app at full width (base 32):
              build from a seeded ``torch.Generator``, prune with
              ``app_masks``, compile with ``PassManager`` + ``compile_plan``,
              serve 10 frames of 256x256 through ``PlanServer(batch_size=4)``;
              checks the node count, the exact kernel launches per plan call,
              zero conv fallbacks, and the output against the reference plan;
              then profiles one more serving run (device time per kernel
              family and the device's idle share);
5. int8    -- the same apps through the INT8 path: calibrate on the f32
              reference plan (2 random batches), run the ``quantize`` pass
              with the app's skip sets, compile for the ``quant`` backend and
              serve as in phase 4; checks the quantized nodes' schemes, the
              exact launches per plan call (conv kernel by scheme,
              quant_matmul, dense_matmul, fused_elementwise), zero conv
              fallbacks, every quantized step's kernel handler against its
              reference handler on the same inputs, and the whole plan
              against the quant reference plan; prints the error against the
              f32 plan, the weight bytes before and after, ms/frame beside
              the f32 plan's, and a profile line;
6. tune    -- the port's ``launch/tune`` for the three apps with
              ``--quantize`` at the served shapes (every key ``|sm90``,
              every ``matmul`` / ``qmatmul`` / ``conv2d`` key swept), then
              each app's f32 and INT8 plans served on the loaded winners
              (outputs ``torch.equal`` to the untuned plans', no cache
              misses, tuned against untuned ms/frame), then with every
              ``matmul`` / ``qmatmul`` entry replaced by a depth-2 and a
              depth-3 tile: exact pipelined-kernel launches per plan call,
              no tiled launch for those nodes, outputs equal again; the
              cache is cleared and tuning turned off after it (every earlier
              phase runs with tuning off and an empty cache);
7. llm smoke -- the decoder's ``serve --llm`` path at qwen2.5-3b's smoke
              config in f32 (prefill / decode plans, ``submit_llm`` over a
              paged KV-cache; exact launches per plan call, zero failed
              sequences and leaked pages, exact greedy parity with the
              plain ``forward``), then the same params block-pruned on
              every q / o projection with ``Block(0.5, 32, 32,
              balanced=False)`` (bands, unperm glue and a standalone rope
              on the card; exact parity against ``forward`` on the masked
              params);
8. llm      -- qwen2.5-3b at full width in bf16, as phase 7 (greedy parity
              up to the first bf16 near-tie, teacher-forced within 8 bf16
              ulps);
9. llm block-pruned -- phase 8's params pruned with the paper's attention
              recipe ``Block(0.5, 64, 64)`` on q / o and served again,
              the dense model released first: 72 ``bsr_matmul`` and 108
              bf16 ``dense_matmul`` launches per plan call, the packed q /
              o bytes at most half the dense ones, the plans' params and
              peak allocated below the dense ones, teacher-forced parity
              against ``forward`` on the masked params.

The line before the last is a JSON object with every kernel's numbers (the
conv kernel once per scheme the main path launches; the pipelined kernels
launch only in the tune phase's serving); the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, and
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

import numpy as np

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the f32 FMA rate on
#: the CUDA cores (the f32 and W8 schemes compute in true f32) and the dense
#: int8 tensor-core rate (the least time of an int8 x int8 contraction)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12

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

#: the INT8 plans: quantized nodes by (op, scheme), then launches per plan
#: call -- the conv kernel by scheme, quant_matmul, dense_matmul,
#: fused_elementwise
EXPECTED_INT8 = {
    "style_transfer": ({("qconv2d", "w8"): 14},
                       {"f32": 2, "w8": 9, "w8a8": 0}, 5, 0, 0),
    "coloring": ({("qconv2d", "w8a8"): 11, ("qlinear", "w8a8"): 1},
                 {"f32": 2, "w8": 0, "w8a8": 10}, 2, 0, 0),
    "super_resolution": ({("qconv2d", "w8"): 16},
                         {"f32": 2, "w8": 8, "w8a8": 0}, 8, 0, 1),
}

_CONV = ("src/repro_torch/kernels/csrc/conv2d.cu", "src/repro/kernels/conv2d.py:175")
#: each entry of the kernels line: where the kernel lives and which TPU
#: kernel it replaces (the conv kernel once per scheme)
KERNELS = {
    "conv2d": _CONV,
    "conv2d_w8": _CONV,
    "conv2d_w8a8": _CONV,
    "dense_matmul": (
        "src/repro_torch/kernels/csrc/dense_matmul.cu", "src/repro/kernels/dense_matmul.py:85",
    ),
    "fused_elementwise": (
        "src/repro_torch/kernels/csrc/fused_elementwise.cu",
        "src/repro/kernels/fused_elementwise.py:39",
    ),
    "quant_matmul": (
        "src/repro_torch/kernels/csrc/quant_matmul.cu", "src/repro/kernels/quant_matmul.py:62",
    ),
    # the decoder path (qwen2.5-3b): the dense kernel once more for its bf16
    # instances; one flash kernel replaces both TPU functions (:31 without
    # lengths, :71 with them -- the main path passes lengths)
    "dense_matmul_bf16": (
        "src/repro_torch/kernels/csrc/dense_matmul.cu", "src/repro/kernels/dense_matmul.py:85",
    ),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:71",
    ),
    "ffn_gateup": (
        "src/repro_torch/kernels/csrc/fused_ffn.cu", "src/repro/kernels/fused_ffn.py:29",
    ),
    # the block-pruned decoder (q / o projections through the compiler's
    # sparse_linear(pbcsr) nodes)
    "bsr_matmul": (
        "src/repro_torch/kernels/csrc/bsr_matmul.cu", "src/repro/kernels/bsr_matmul.py:41",
    ),
    # the tuning path: matmul / qmatmul winners with pipeline depth >= 2
    "dense_matmul_pipelined": (
        "src/repro_torch/kernels/csrc/dense_matmul_pipelined.cu",
        "src/repro/kernels/dense_matmul.py:121",
    ),
    "quant_matmul_pipelined": (
        "src/repro_torch/kernels/csrc/quant_matmul_pipelined.cu",
        "src/repro/kernels/quant_matmul.py:104",
    ),
}

#: the decoder phases: the JAX CLI's ``serve --llm`` defaults (3 prompts of
#: 4..16 tokens, 12 new tokens each, 4 sequences decoding together, a
#: 64 x 16-token KV pool) on the kernel backend
LLM_ARGS = dict(arch="qwen2.5-3b", batch=4, prompt_len=16, new_tokens=12, frames=3,
                kv_pages=64, kv_page_size=16, max_queue=1024, seed=SEED, device="cuda")
#: qwen2.5-3b's layers: each launches 5 bf16 dense_matmul (q, k, v, o, down)
#: and one ffn_gateup per plan call
LLM_LAYERS = 36


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


#: profiler sessions tried before a timing gives up on the profiler: now and
#: then a session returns no device events at all for kernels that ran (seen
#: once for a 6 us kernel that other sessions of the same script timed)
PROFILE_ATTEMPTS = 3


def profiled_us(torch, fn, reps: int, warmup: int = 3) -> float:
    """Device time of ``reps`` calls of ``fn``: the time of every kernel they
    launch, from torch.profiler (host work between launches is not
    counted).  A session that sees no device time is tried again, up to
    ``PROFILE_ATTEMPTS`` sessions; 0 if none saw any."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_ATTEMPTS):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us
    return 0.0


def device_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``, averaged over ``reps`` calls; where
    no profiler session saw device time, its time on the stream between CUDA
    events instead (said on a line of its own)."""
    us = profiled_us(torch, fn, reps)
    if us > 0:
        return us / reps / 1e3
    ms = call_ms(torch, fn, reps)
    print(f"  (the profiler saw no device time in {PROFILE_ATTEMPTS} sessions; "
          f"timed with CUDA events: {ms:.4f} ms)")
    return ms


def library_ms(torch, fn, reps: int = 20):
    """The library yardstick's time per call: its device time, or -- where
    the profiler attributes none of its kernels, as it did for one cuDNN
    convolution -- its time on the stream between CUDA events.  Returns the
    time and how it was taken."""
    us = profiled_us(torch, fn, reps)
    if us > 0:
        return us / reps / 1e3, "profiler"
    return call_ms(torch, fn, reps), "events"


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


def bound(nbytes: float, flops: float, peak_ops: float = PEAK_F32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_path_launches(ops):
    """The launch counts by entry of the kernels line (the conv kernel by
    scheme)."""
    counts = ops.kernel_launch_counts()
    by_scheme = ops.conv_scheme_launch_counts()
    by_dtype = ops.dense_dtype_launch_counts()
    return {
        "conv2d": by_scheme["f32"], "conv2d_w8": by_scheme["w8"],
        "conv2d_w8a8": by_scheme["w8a8"], "dense_matmul": by_dtype["f32"],
        "fused_elementwise": counts["fused_elementwise"], "quant_matmul": counts["quant_matmul"],
        "dense_matmul_bf16": by_dtype["bf16"], "flash_attention": counts["flash_attention"],
        "ffn_gateup": counts["ffn_gateup"], "bsr_matmul": counts["bsr_matmul"],
        "dense_matmul_pipelined": counts["dense_matmul_pipelined"],
        "quant_matmul_pipelined": counts["quant_matmul_pipelined"],
    }


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
    sass_check(path)


#: the CUDA-core GEMM templates that must hold no bf16 instance: bf16 runs
#: the tensor-core kernel (mma_gemm_kernel) and the skinny kernel
_FMA_GEMMS = ("dense_matmul_kernel", "ffn_gateup_kernel", "pipelined_gemm_kernel")


def sass_check(lib_path):
    """The built library's SASS (cuobjdump): every tensor-core GEMM kernel
    issues HMMA, and no CUDA-core GEMM kernel is instantiated for bf16."""
    import re

    from repro_torch.kernels import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    hmma, fma_bf16 = {}, []
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if "mma_gemm_kernel" in name:
            hmma[name] = chunk.count("HMMA")
        if any(k in name for k in _FMA_GEMMS) and "bfloat16" in name:
            fma_bf16.append(name)
    check(hmma and min(hmma.values()) > 0,
          f"sass: tensor-core kernels without HMMA: {[n for n, c in hmma.items() if not c]}")
    check(not fma_bf16, f"sass: CUDA-core bf16 GEMM instances remain: {fma_bf16[:3]}")
    print(f"  sass: {len(hmma)} mma_gemm_kernel instances, HMMA per kernel "
          f"{min(hmma.values())}..{max(hmma.values())}; no bf16 instance of "
          f"{', '.join(_FMA_GEMMS)}")


def phase_kernels(torch):
    """Every kernel against its plain version at the main path's shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels import dense_matmul as kdense
    from repro_torch.kernels import dense_matmul_pipelined as kdense_pipe
    from repro_torch.kernels import fused_elementwise as kfused
    from repro_torch.kernels import quant_matmul as kquant
    from repro_torch.kernels import quant_matmul_pipelined as kquant_pipe
    from repro_torch.kernels.ref import _ACT, xla_conv_pads
    from repro_torch.quant import QTensor, quantize_array

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    results = {name: [] for name in KERNELS}

    def record(name, label, out, want, kernel, plain, library, nb, flops, rtol=1e-4,
               peak_ops=PEAK_F32_FLOPS):
        err = (out - want).abs().max().item()
        tol = rtol * max(1.0, want.abs().max().item())
        b_ms, b_by = bound(nb, flops, peak_ops)
        ms, plain_ms = device_ms(torch, kernel), device_ms(torch, plain, reps=5)
        lib_ms, lib_how = (None, None) if library is None else library_ms(torch, library)
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}" + (
            "(events)" if lib_how == "events" else "")
        print(f"  {name:18s} {label:42s} max_err={err:.3e} (tol {tol:.1e}) "
              f"ms={ms:.4f} call_ms={call_ms(torch, kernel):.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib} bound_ms={b_ms:.4f} ({b_by})")
        check(err <= tol, f"{name} {label}: max_err {err} > {tol}")
        results[name].append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))

    def tiles_line(name, label, call, ref, want, tol, tiles):
        """Every tile of a kernel family once (``call(tile)``): torch.equal
        to the default tile's output ``ref`` and within ``tol`` of the plain
        version's ``want``; device ms of each."""
        parts = []
        for t in tiles:
            out = call(t)
            check(torch.equal(out, ref), f"{name} tile {t} {label}: differs from the default tile")
            err = (out.float() - want.float()).abs().max().item()
            check(err <= tol, f"{name} tile {t} {label}: max_err {err} > {tol}")
            parts.append(f"{'x'.join(map(str, t))}={device_ms(torch, lambda t=t: call(t), 10):.4f}")
        print(f"  {name:18s} every tile, {label}: {' '.join(parts)} ms "
              f"(each torch.equal to the default tile)")

    # -- conv2d -------------------------------------------------------------- #
    def conv_case(label, n, c_in, hw, o, k, stride, c_live=None, act=None, add_side=False,
                  scheme="f32", tiles=False):
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
        w_lib = wt
        if scheme != "f32":  # the operands as ops.conv2d hands them to the kernel
            qt = QTensor.from_float(wt, axis=0)
            wt, ws = qt.values, qt.scale
            if scheme == "w8a8":
                x_scale = torch.full((1,), x.abs().max().item() / 127.0, device=dev)
                x, ws = quantize_array(x, x_scale), ws * x_scale
            kw["ws"] = ws
            w_lib = wt.float() * ws[:, None, None, None]
        out = kconv.conv2d_gemm(x, wt, b, *sides, **kw)
        want = kconv.conv2d_plain(x, wt, b, *sides, **kw)
        # library yardstick: cuDNN (TF32 off) on the gathered, XLA-padded
        # input and, for the INT8 schemes, the dequantized filter (the
        # gather, the pad and the dequantization are prepared outside the
        # timing)
        xg = x if kept is None else x.index_select(1, kept)
        ph = xla_conv_pads(h, k, stride, "SAME", 0)
        pw = xla_conv_pads(w_, k, stride, "SAME", 1)
        xp = F.pad(xg.float(), (pw[0], pw[1], ph[0], ph[1]))

        def library():
            y = _ACT[act](F.conv2d(xp, w_lib, b, stride=stride))
            return y + sides[0] if add_side else y

        nb = nbytes(xg, wt, kw.get("ws"), b, kept, *sides, out)
        flops = 2.0 * n * oh * ow * o * c * k * k
        name = "conv2d" if scheme == "f32" else f"conv2d_{scheme}"
        rtol = 1e-5 if scheme == "w8a8" else 1e-4
        record(name, label, out, want, lambda: kconv.conv2d_gemm(x, wt, b, *sides, **kw),
               lambda: kconv.conv2d_plain(x, wt, b, *sides, **kw), library, nb, flops,
               rtol=rtol, peak_ops=PEAK_INT8_OPS if scheme == "w8a8" else PEAK_F32_FLOPS)
        if tiles:
            tiles_line(name, label, lambda t: kconv.conv2d_gemm(
                x, wt, b, *sides, **kw, block_m=t[0], block_n=t[1], block_k=t[2]),
                out, want, rtol * max(1.0, want.abs().max().item()), _build.CONV_TILES)

    conv_case("7x7 s1 3->32 @256^2 n4", BATCH, 3, (SIZE, SIZE), BASE, 7, 1, tiles=True)
    conv_case("3x3 s2 16-of-32->64 @256^2 n4", BATCH, 32, (SIZE, SIZE), 64, 3, 2, c_live=16)
    conv_case("3x3 s1 96-of-192->32 +add @256^2 n4", BATCH, 192, (SIZE, SIZE), 32, 3, 1,
              c_live=96, add_side=True)
    conv_case("3x3 s1 8-of-16->2 tanh @256^2 n4", BATCH, 16, (SIZE, SIZE), 2, 3, 1,
              c_live=8, act="tanh")
    conv_case("3x3 s2 24->40 relu @37x29 n2", 2, 24, (37, 29), 40, 3, 2, act="relu")
    # INT8 schemes: the first case of each is its headline (main-path shape)
    conv_case("w8 3x3 s1 96-of-192->32 +add @256^2 n4", BATCH, 192, (SIZE, SIZE), 32, 3, 1,
              c_live=96, add_side=True, scheme="w8", tiles=True)
    conv_case("w8 3x3 s2 16-of-32->64 @256^2 n4", BATCH, 32, (SIZE, SIZE), 64, 3, 2,
              c_live=16, scheme="w8")
    conv_case("w8 3x3 s2 24->40 relu @37x29 n2", 2, 24, (37, 29), 40, 3, 2, act="relu",
              scheme="w8")
    conv_case("w8a8 3x3 s1 64-of-128->128 relu @64^2 n4", BATCH, 128, (64, 64), 128, 3, 1,
              c_live=64, act="relu", scheme="w8a8", tiles=True)
    conv_case("w8a8 3x3 s2 32-of-64->64 relu @128^2 n4", BATCH, 64, (128, 128), 64, 3, 2,
              c_live=32, act="relu", scheme="w8a8")
    conv_case("w8a8 3x3 s2 24->40 +add @37x29 n2", 2, 24, (37, 29), 40, 3, 2, add_side=True,
              scheme="w8a8")

    def gemm_call(tiled, pipelined):
        """``call(tile)`` for tiles_line: the tiled kernel at depth 1, the
        pipelined one above it."""
        def call(t, *args, **kw):
            if t[3] == 1:
                return tiled(*args, **kw, block_m=t[0], block_n=t[1], block_k=t[2])
            return pipelined(*args, **kw, block_m=t[0], block_n=t[1], block_k=t[2], depth=t[3])
        return call

    def pipelined_cases(name, label, fn, plain, out, want, library, nb, flops, **rec):
        """The pipelined kernel at depth 2 and 3 on the case's inputs (its
        default tile): torch.equal to the tiled kernel's ``out``, and within
        tolerance of the plain version as ``record`` checks."""
        for depth in (2, 3):
            got = fn(depth)
            check(torch.equal(got, out), f"{name} depth {depth} {label}: differs from the "
                                         f"tiled kernel")
            record(name, f"d{depth} {label}", got, want, lambda d=depth: fn(d), plain, library,
                   nb, flops, **rec)

    # -- dense_matmul -------------------------------------------------------- #
    def dense_case(label, m, k, n, act=None, sides_epi=False, pipelined=False, tiles=False):
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

        nb, flops = nbytes(x, wt, b, *sides, out), 2.0 * m * n * k
        record("dense_matmul", label, out, want,
               lambda: kdense.dense_matmul(x, wt, b, *sides, **kw),
               lambda: kdense.dense_matmul_plain(x, wt, b, *sides, **kw), library, nb, flops)
        if pipelined:
            pipelined_cases("dense_matmul_pipelined", label, lambda d: kdense_pipe.
                            dense_matmul_pipelined(x, wt, b, *sides, **kw, depth=d),
                            lambda: kdense.dense_matmul_plain(x, wt, b, *sides, **kw),
                            out, want, library, nb, flops)
        if tiles:
            call = gemm_call(kdense.dense_matmul, kdense_pipe.dense_matmul_pipelined)
            tiles_line("dense_matmul", label, lambda t: call(t, x, wt, b, *sides, **kw), out,
                       want, 1e-4 * max(1.0, want.abs().max().item()), _build.GEMM_TILES)

    dense_case("M=4*256^2 K=32 N=192 relu", BATCH * SIZE * SIZE, BASE, 6 * BASE, act="relu",
               pipelined=True, tiles=True)
    dense_case("M=4 K=64 N=64", BATCH, 2 * BASE, 2 * BASE)
    dense_case("M=1000 K=50 N=70 add+mul", 1000, 50, 70, sides_epi=True, pipelined=True)

    # -- quant_matmul -------------------------------------------------------- #
    def quant_case(label, m, k, n, scheme, act=None, sides_epi=False, tiles=False):
        x = randn(m, k)
        qt = QTensor.from_float(randn(k, n, scale=k ** -0.5), axis=1)
        wq, ws = qt.values, qt.scale
        b = randn(n, scale=0.1)
        if scheme == "w8a8":  # the operands as ops.qmatmul hands them to the kernel
            x_scale = torch.full((1,), x.abs().max().item() / 127.0, device=dev)
            x, ws = quantize_array(x, x_scale), ws * x_scale
        sides = (randn(m, n), randn(m, n)) if sides_epi else ()
        epi = (("add", 0), ("mul", 1)) if sides_epi else ()
        kw = dict(activation=act, epilogue=epi)
        out = kquant.quant_matmul(x, wq, ws, b, *sides, **kw)
        want = kquant.quant_matmul_plain(x, wq, ws, b, *sides, **kw)

        def tail(y):
            y = _ACT[act](y)
            return (y + sides[0]) * sides[1] if sides_epi else y

        # library yardstick: an int32 GEMM where torch._int_mm's shape rules
        # allow it (M > 16, K and N multiples of 8), then the rescale; for
        # W8, addmm on the dequantized f32 weight (prepared outside timing)
        library = None
        if scheme == "w8a8" and m > 16 and k % 8 == 0 and n % 8 == 0:
            def library():
                return tail(torch._int_mm(x, wq).float() * ws + b)
        elif scheme == "w8":
            w_deq = wq.float() * ws

            def library():
                return tail(torch.addmm(b, x, w_deq))

        nb, flops = nbytes(x, wq, ws, b, *sides, out), 2.0 * m * n * k
        rec = dict(rtol=1e-5 if scheme == "w8a8" else 1e-4,
                   peak_ops=PEAK_INT8_OPS if scheme == "w8a8" else PEAK_F32_FLOPS)
        record("quant_matmul", label, out, want,
               lambda: kquant.quant_matmul(x, wq, ws, b, *sides, **kw),
               lambda: kquant.quant_matmul_plain(x, wq, ws, b, *sides, **kw), library, nb, flops,
               **rec)
        pipelined_cases("quant_matmul_pipelined", label, lambda d: kquant_pipe.
                        quant_matmul_pipelined(x, wq, ws, b, *sides, **kw, depth=d),
                        lambda: kquant.quant_matmul_plain(x, wq, ws, b, *sides, **kw),
                        out, want, library, nb, flops, **rec)
        if tiles:
            call = gemm_call(kquant.quant_matmul, kquant_pipe.quant_matmul_pipelined)
            tiles_line("quant_matmul", label, lambda t: call(t, x, wq, ws, b, *sides, **kw), out,
                       want, rec["rtol"] * max(1.0, want.abs().max().item()), _build.GEMM_TILES)

    quant_case("w8 M=4*256^2 K=32 N=192 relu", BATCH * SIZE * SIZE, BASE, 6 * BASE, "w8",
               act="relu", tiles=True)
    quant_case("w8a8 M=4*64^2 K=128 N=64 relu", BATCH * 64 * 64, 4 * BASE, 2 * BASE, "w8a8",
               act="relu", tiles=True)
    quant_case("w8a8 M=4 K=64 N=64 relu", BATCH, 2 * BASE, 2 * BASE, "w8a8", act="relu")
    quant_case("w8 M=37 K=70 N=50 add+mul", 37, 70, 50, "w8", sides_epi=True)
    quant_case("w8a8 M=37 K=70 N=50 add+mul", 37, 70, 50, "w8a8", sides_epi=True)

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


def attention_work(q_shape, kv_shape, lengths, causal):
    """Keys each query row reads under the kernel's rule (a row reads its
    valid prefix: ``col < length`` and, causal, ``col <= row``; a row with
    no valid key reads every key, masked), as ``(key rows per (b, kv
    group), query-key pairs)``."""
    b, h, sq, _ = q_shape
    g, skv = kv_shape[1], kv_shape[2]
    kv_rows = pairs = 0
    for bi in range(b):
        n = skv if lengths is None else int(lengths[bi])
        if n <= 0:
            row_keys = [skv] * sq
        else:
            n = min(n, skv)
            row_keys = [min(n, r + 1) if causal else n for r in range(sq)]
        kv_rows += g * max(row_keys)
        pairs += h * sum(row_keys)
    return kv_rows, pairs


def phase_llm_kernels(torch, results):
    """The decoder's kernels at qwen2.5-3b's shapes (d_model 2048, 16 heads,
    2 KV heads, head_dim 128, d_ff 11008) against their plain versions:
    flash attention (prefill, decode, no lengths), the fused gate/up FFN and
    the bf16 dense matmul of the q / k / v / o / down projections."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import dense_matmul as kdense
    from repro_torch.kernels import dense_matmul_pipelined as kdense_pipe
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import fused_ffn as kffn
    from repro_torch.kernels.ref import _ACT, bf16_ulp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def record(name, label, out, want, kernel, plain, library, nb, flops, peak_ops):
        out, want = out.float(), want.float()
        err = (out - want).abs().max().item()
        top = want.abs().max().item()
        # f32 outputs: the f32 sums differ in order only; bf16 outputs: the
        # same f32 sums rounded once, so one bf16 ulp of the largest value
        bf = kernel().dtype == torch.bfloat16
        tol = bf16_ulp(top) if bf else 1e-4 * max(1.0, top)
        b_ms, b_by = bound(nb, flops, peak_ops)
        ms, plain_ms = device_ms(torch, kernel), device_ms(torch, plain, reps=5)
        lib_ms, lib_how = (None, None) if library is None else library_ms(torch, library)
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}" + (
            "(events)" if lib_how == "events" else "")
        print(f"  {name:18s} {label:42s} max_err={err:.3e} (tol {tol:.1e}) "
              f"ms={ms:.4f} call_ms={call_ms(torch, kernel):.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib} bound_ms={b_ms:.4f} ({b_by})")
        check(err <= tol, f"{name} {label}: max_err {err} > {tol}")
        results.setdefault(name, []).append(dict(
            label=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by))

    # -- flash_attention ----------------------------------------------------- #
    def flash_case(label, b, h, g, sq, skv, d, lengths, causal, q_dtype, kv_dtype):
        # the executor's layouts: q [B, S, H*d] and k/v [B, S, G*d] viewed as
        # [B, heads, S, d] (strided, no copy)
        q = randn(b, sq, h, d, dtype=q_dtype).permute(0, 2, 1, 3)
        k = randn(b, skv, g, d, dtype=kv_dtype).permute(0, 2, 1, 3)
        v = randn(b, skv, g, d, dtype=kv_dtype).permute(0, 2, 1, 3)
        lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=dev)
        kw = dict(causal=causal)
        out = kflash.flash_attention(q, k, v, lens, **kw)
        want = kflash.flash_attention_plain(q, k, v, lens, **kw)
        # library yardstick: SDPA on the same function -- KV groups repeated
        # and a boolean mask built outside the timing, q in k's type
        rep = h // g
        kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        ql = q.to(kv_dtype)
        cols = torch.arange(skv, device=dev)
        mask = torch.ones(b, 1, sq, skv, dtype=torch.bool, device=dev)
        if causal:
            mask &= cols[None, None, None, :] <= torch.arange(sq, device=dev)[None, None, :, None]
        if lens is not None:
            mask &= cols[None, None, None, :] < lens[:, None, None, None]

        def library():
            return F.scaled_dot_product_attention(ql, kr, vr, attn_mask=mask)

        kv_rows, pairs = attention_work(q.shape, k.shape, lengths, causal)
        esz_q, esz_kv = q.element_size(), k.element_size()
        nb = 2 * q.numel() * esz_q + 2 * kv_rows * d * esz_kv + (0 if lens is None else 4 * b)
        both_bf16 = q_dtype == bf16 and kv_dtype == bf16
        record("flash_attention", label, out, want,
               lambda: kflash.flash_attention(q, k, v, lens, **kw),
               lambda: kflash.flash_attention_plain(q, k, v, lens, **kw), library, nb,
               4.0 * pairs * d, PEAK_BF16_FLOPS if both_bf16 else PEAK_F32_FLOPS)

    flash_case("decode q bf16 kv f32 B3 H16/G2 span1024 +len", 3, 16, 2, 1, 1024, 128,
               [1000, 517, 64], False, bf16, torch.float32)
    flash_case("prefill bf16 B3 H16/G2 S16 causal +len", 3, 16, 2, 16, 16, 128,
               [16, 11, 5], True, bf16, bf16)
    flash_case("bf16 B3 H16/G2 S100 causal, no lengths", 3, 16, 2, 100, 100, 128,
               None, True, bf16, bf16)
    flash_case("f32 B2 H4/G2 Sq3 Skv37 d32 +len (0 incl.)", 2, 4, 2, 3, 37, 32,
               [0, 29], False, torch.float32, torch.float32)

    #: device ms of the decoder's GEMM launches by phase and role, for the
    #: per-plan-call sums below
    per_call = {"prefill": {}, "decode": {}}

    # -- ffn_gateup ---------------------------------------------------------- #
    def ffn_case(label, m, k, f, dtype, act="silu", role=None):
        x = randn(m, k, dtype=dtype)
        wg = randn(k, f, scale=k ** -0.5, dtype=dtype)
        wu = randn(k, f, scale=k ** -0.5, dtype=dtype)
        out = kffn.ffn_gateup(x, wg, wu, activation=act)
        want = kffn.ffn_gateup_plain(x, wg, wu, activation=act)
        actf = _ACT[act]

        def library():
            return actf(torch.matmul(x, wg)) * torch.matmul(x, wu)

        peak = PEAK_BF16_FLOPS if dtype == bf16 else PEAK_F32_FLOPS
        record("ffn_gateup", label, out, want,
               lambda: kffn.ffn_gateup(x, wg, wu, activation=act),
               lambda: kffn.ffn_gateup_plain(x, wg, wu, activation=act), library,
               nbytes(x, wg, wu, out), 4.0 * m * k * f, peak)
        if role:
            per_call[role[0]][role[1]] = results["ffn_gateup"][-1]["ms"]

    ffn_case("decode M=3 K=2048 F=11008 bf16 silu", 3, 2048, 11008, bf16,
             role=("decode", "ffn"))
    ffn_case("prefill M=48 K=2048 F=11008 bf16 silu", 48, 2048, 11008, bf16,
             role=("prefill", "ffn"))
    ffn_case("M=5 K=70 F=50 f32 gelu (ragged)", 5, 70, 50, torch.float32, "gelu")
    ffn_case("M=20 K=130 F=77 bf16 silu (ragged)", 20, 130, 77, bf16)

    # -- dense_matmul, bf16 -------------------------------------------------- #
    def dense_bf16_case(label, m, k, n, bias=True, add=False, pipelined=False, role=None):
        x = randn(m, k, dtype=bf16)
        wt = randn(k, n, scale=k ** -0.5, dtype=bf16)
        b = randn(n, scale=0.1, dtype=bf16) if bias else None
        sides = (randn(m, n, dtype=bf16),) if add else ()
        kw = dict(epilogue=(("add", 0),) if add else ())
        out = kdense.dense_matmul(x, wt, b, *sides, **kw)
        want = kdense.dense_matmul_plain(x, wt, b, *sides, **kw)

        def library():
            y = torch.addmm(b, x, wt) if bias else torch.matmul(x, wt)
            return y + sides[0] if add else y

        nb, flops = nbytes(x, wt, b, *sides, out), 2.0 * m * n * k
        plain = lambda: kdense.dense_matmul_plain(x, wt, b, *sides, **kw)  # noqa: E731
        record("dense_matmul_bf16", label, out, want,
               lambda: kdense.dense_matmul(x, wt, b, *sides, **kw), plain, library, nb, flops,
               PEAK_BF16_FLOPS)
        if role:
            per_call[role[0]][role[1]] = results["dense_matmul_bf16"][-1]["ms"]
        if not pipelined:
            return
        # the ring kernel at depth 2 and 3 (bit-equal to the tiled kernel),
        # then every bf16 GEMM tile once (bit-equal to the default tile)
        for depth in (2, 3):
            fn = lambda d=depth: kdense_pipe.dense_matmul_pipelined(  # noqa: E731
                x, wt, b, *sides, **kw, depth=d)
            got = fn()
            check(torch.equal(got, out), f"dense_matmul_pipelined bf16 d{depth} {label}: "
                                         f"differs from the tiled kernel")
            record("dense_matmul_pipelined", f"d{depth} bf16 {label}", got, want, fn, plain,
                   library, nb, flops, PEAK_BF16_FLOPS)
        parts = []
        for t in _build.BF16_GEMM_TILES:
            def call(t=t):
                if t[3] == 1:
                    return kdense.dense_matmul(x, wt, b, *sides, **kw, block_m=t[0],
                                               block_n=t[1], block_k=t[2])
                return kdense_pipe.dense_matmul_pipelined(
                    x, wt, b, *sides, **kw, block_m=t[0], block_n=t[1], block_k=t[2], depth=t[3])
            check(torch.equal(call(), out), f"dense_matmul bf16 tile {t} {label}: differs from "
                                            f"the default tile")
            parts.append(f"{'x'.join(map(str, t))}={device_ms(torch, call, 10):.4f}")
        print(f"  {'dense_matmul_bf16':18s} every tile, {label}: {' '.join(parts)} ms "
              f"(each torch.equal to the default tile)")

    # every projection the decoder plans launch, at decode (M = 3 rows, the
    # skinny kernel) and at prefill (M = 48, the tensor-core kernel)
    dense_bf16_case("q decode M=3 2048->2048 +bias", 3, 2048, 2048, role=("decode", "q"))
    dense_bf16_case("k/v decode M=3 2048->256 +bias", 3, 2048, 256, role=("decode", "kv"))
    dense_bf16_case("o decode M=3 2048->2048 +add", 3, 2048, 2048, bias=False, add=True,
                    role=("decode", "o"))
    dense_bf16_case("down decode M=3 11008->2048 +add", 3, 11008, 2048, bias=False, add=True,
                    role=("decode", "down"))
    dense_bf16_case("q prefill M=48 2048->2048 +bias", 48, 2048, 2048, pipelined=True,
                    role=("prefill", "q"))
    dense_bf16_case("k/v prefill M=48 2048->256 +bias", 48, 2048, 256, role=("prefill", "kv"))
    dense_bf16_case("o prefill M=48 2048->2048 +add", 48, 2048, 2048, bias=False, add=True,
                    role=("prefill", "o"))
    dense_bf16_case("down prefill M=48 11008->2048 +add", 48, 11008, 2048, bias=False, add=True,
                    role=("prefill", "down"))
    dense_bf16_case("M=5 K=70 N=50 +add (ragged)", 5, 70, 50, add=True)
    # odd K and N: bf16 rows not 4-byte aligned, staged by element loads
    dense_bf16_case("M=20 K=71 N=51 +add (odd K, N)", 20, 71, 51, add=True, pipelined=True)
    # device ms of one plan call's GEMM launches: per layer q, k, v, o, down
    # (5 dense_matmul) and one ffn_gateup, over qwen2.5-3b's 36 layers
    for phase, t in per_call.items():
        dense = LLM_LAYERS * (t["q"] + 2 * t["kv"] + t["o"] + t["down"])
        ffn = LLM_LAYERS * t["ffn"]
        print(f"  per {phase} plan call ({LLM_LAYERS} layers, device ms x launches): "
              f"dense_matmul_bf16 {5 * LLM_LAYERS} launches {dense:.3f} ms, ffn_gateup "
              f"{LLM_LAYERS} launches {ffn:.3f} ms, together {dense + ffn:.3f} ms")
    phase_bsr_kernels(torch, record)
    torch.cuda.synchronize()
    return results


def phase_bsr_kernels(torch, record):
    """The block-sparse kernel against its plain version: the full-width
    pruned q / o projections (qwen2.5-3b, ``Block(0.5, bm=64, bn=64)``
    balanced, packed on the card) at decode and prefill, then f32 cases with
    bands, pads and an empty band.  Each band is one wrapper call writing
    into one output, as ``ops.bsr_matmul`` makes them.  Bound: the real
    blocks' bytes + block_rows + x + out + bias + sides, and
    2 * M * bm * bn per real block."""
    from repro_torch.core.pruning import Block, project
    from repro_torch.core.sparse import PBCSR
    from repro_torch.kernels import bsr_matmul as kbsr
    from repro_torch.kernels.ref import _ACT

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def banded(fn, x, values, rows, bias, sides, bands, epi, act):
        out = torch.empty((x.shape[0], values.shape[0] * values.shape[3]), dtype=x.dtype,
                          device=dev)
        for band in bands:
            fn(x, values, rows, bias, *sides, activation=act, epilogue=epi, band=band, out=out)
        return out

    def case(label, x, w, mask, bm, bn, bias=None, add=False, bands=None, act=None):
        f = PBCSR.from_dense(w, mask, bm, bn)
        values, rows = f.values, f.block_rows
        nb, s = rows.shape
        bands = bands or ((0, nb, s),)
        m, n = x.shape[0], nb * bn
        sides = (randn(m, n, dtype=x.dtype),) if add else ()
        epi = (("add", 0),) if add else ()
        args = (x, values, rows, bias, sides, bands, epi, act)
        out = banded(kbsr.bsr_matmul, *args)
        want = banded(kbsr.bsr_matmul_plain, *args)
        live = torch.zeros_like(rows, dtype=torch.bool)
        for start, stop, count in bands:
            live[start:stop, :count] = True
        real = int(((rows >= 0) & live).sum())
        dense = f.to_dense()

        def library():
            y = torch.addmm(bias, x, dense) if bias is not None else torch.matmul(x, dense)
            y = _ACT[act](y)
            return y + sides[0] if add else y

        nb_bytes = real * bm * bn * values.element_size() + nbytes(rows, x, bias, *sides, out)
        peak = PEAK_BF16_FLOPS if x.dtype == bf16 else PEAK_F32_FLOPS
        record("bsr_matmul", label, out, want, lambda: banded(kbsr.bsr_matmul, *args),
               lambda: banded(kbsr.bsr_matmul_plain, *args), library, nb_bytes,
               2.0 * m * real * bm * bn, peak)
        return rows

    # full width: the headline (decode q) first
    w_q = randn(2048, 2048, scale=2048 ** -0.5, dtype=bf16)
    w_o = randn(2048, 2048, scale=2048 ** -0.5, dtype=bf16)
    blk = Block(0.5, bm=64, bn=64)
    m_q, m_o = project(w_q, blk)[1], project(w_o, blk)[1]
    b_q = randn(2048, scale=0.1, dtype=bf16)
    rows = case("q decode M=3 2048->2048 b64 S=16 +bias", randn(3, 2048, dtype=bf16), w_q, m_q,
                64, 64, bias=b_q)
    check(tuple(rows.shape) == (32, 16) and bool((rows >= 0).all()),
          f"bsr q: balanced packing {tuple(rows.shape)}")
    case("q prefill M=48 2048->2048 b64 S=16 +bias", randn(48, 2048, dtype=bf16), w_q, m_q,
         64, 64, bias=b_q)
    case("o decode M=3 2048->2048 b64 S=16 +add", randn(3, 2048, dtype=bf16), w_o, m_o, 64, 64,
         add=True)
    case("o prefill M=48 2048->2048 b64 S=16 +add", randn(48, 2048, dtype=bf16), w_o, m_o,
         64, 64, add=True)
    # the test MLP's first layer (256 -> 512, Block(0.5, 128, 128,
    # balanced=False)), numpy-seeded so its pads are known: two bands over
    # the unpermuted packing, pads inside them, an add side
    rng = np.random.default_rng(SEED + 3)
    w1 = torch.from_numpy((rng.standard_normal((256, 512)) * 0.05).astype(np.float32)).to(dev)
    m1 = project(w1, Block(0.5, bm=128, bn=128, balanced=False))[1]
    s1 = int(PBCSR.from_dense(w1, m1, 128, 128).block_rows.shape[1])
    rows = case("f32 MLP l1 M=8 256->512 b128 2 bands +pad +add", randn(8, 256), w1, m1,
                128, 128, bias=randn(512, scale=0.1), add=True,
                bands=((0, 1, s1), (1, 4, s1)))
    check(bool((rows < 0).any()), "bsr MLP case: no pad in the packing")
    # an empty band: columns 0-1 keep nothing (the reorder pass's count-0 band)
    bmask = torch.tensor([[0, 0, 1, 1], [0, 0, 0, 1], [0, 0, 1, 1]], dtype=torch.float32,
                         device=dev)
    m2 = torch.kron(bmask, torch.ones((16, 24), device=dev))
    case("f32 M=5 48->96 b16x24 empty band +relu", randn(5, 48), randn(48, 96), m2, 16, 24,
         bias=randn(96), bands=((0, 2, 0), (2, 3, 2), (3, 4, 3)), act="relu")


def serve_measured(torch, ops, plan, params, frames, app):
    """Serve ``frames`` through ``PlanServer(batch_size=BATCH)``: one warm-up
    run, then ``TIMING_REPS`` timed runs with every launch count and the
    fallback counter set to 0 just before them and read just after.
    Returns the last output, the median seconds per run, the launches by
    kernels-line entry, the number of plan calls, the peak allocated bytes
    and the serving function (for the profile line)."""
    from repro_torch.serving import PlanServer

    def serve():
        server = PlanServer(plan, params, BATCH, name=app)
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
    launches = main_path_launches(ops)
    counts = ops.kernel_launch_counts()
    fallbacks = ops.conv_fallback_counts()
    peak = torch.cuda.max_memory_allocated()
    check(stats["batches"] == 3 and stats["padded_frames"] == 2,
          f"{app}: served {stats}, want 3 chunks with 2 padded frames")
    check(sum(fallbacks.values()) == 0, f"{app}: conv fallbacks {fallbacks}")
    calls = stats["batches"] * TIMING_REPS
    return dict(out=out, sec=statistics.median(times), launches=launches, counts=counts,
                calls=calls, peak=peak, serve=serve)


def check_per_call(app, counts, calls, want):
    for name, n in want.items():
        check(counts[name] == n * calls,
              f"{app}: {name} launched {counts[name]} times over {calls} plan calls, "
              f"want {n} per call")


def phase_apps(torch, np):
    from repro_torch.core.graph import PassContext, PassManager, compile_plan
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import APP_INPUT_CHANNELS, APPS, app_masks

    launches = {name: 0 for name in KERNELS}
    apps = {}
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
        run = serve_measured(torch, ops, plan, go.params, frames, app)
        check_per_call(app, run["counts"], run["calls"], {
            "conv2d": n_conv, "dense_matmul": n_dense, "fused_elementwise": n_fused,
            "quant_matmul": 0})
        for name, n in run["launches"].items():
            launches[name] += n
        out = run["out"]
        want = torch.cat(
            [ref_plan(go.params, frames[i:i + BATCH]) for i in range(0, FRAMES, BATCH)]
        )
        check(tuple(out.shape) == tuple(want.shape), f"{app}: shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{app}: non-finite output")
        err = (out - want).abs().max().item()
        tol = 1e-3 * max(1.0, want.abs().max().item())
        check(err <= tol, f"{app}: max|kernel plan - reference plan| {err} > {tol}")
        sec = run["sec"]
        print(f"  {app:16s} nodes={len(go.nodes)} per-call launches conv2d={n_conv} "
              f"dense_matmul={n_dense} fused_elementwise={n_fused} fallbacks=0 "
              f"out={tuple(out.shape)} max_err={err:.3e} (tol {tol:.1e}) "
              f"ms/frame={sec / FRAMES * 1e3:.3f} frames/s={FRAMES / sec:.1f} "
              f"(median of {TIMING_REPS} x {FRAMES} frames) "
              f"peak_alloc={run['peak'] / 1e6:.1f}MB est_peak_act@batch{BATCH}="
              f"{mem['peak_activation_bytes'] / 1e6:.1f}MB")
        profile_serving(torch, app, run["serve"])
        apps[app] = dict(go=go, frames=frames, ref_plan=ref_plan, ms_per_frame=sec / FRAMES * 1e3,
                         plan=plan, out=out)
    return launches, apps


def phase_int8(torch, np, apps):
    """The INT8 path of each app, on the f32 graphs phase 4 built."""
    from repro_torch.core.graph import PassContext, PassManager, compile_plan
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import APP_ACT_SKIP, APP_INPUT_CHANNELS, APP_QUANT_SKIP
    from repro_torch.quant import calibrate_plan

    launches = {name: 0 for name in KERNELS}
    rng = np.random.default_rng(SEED + 1)
    for app, (schemes, conv_by_scheme, n_quant, n_dense, n_fused) in EXPECTED_INT8.items():
        go, frames, f32_plan = apps[app]["go"], apps[app]["frames"], apps[app]["ref_plan"]
        shape = (BATCH, APP_INPUT_CHANNELS[app], SIZE, SIZE)
        batches = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda")
                   for _ in range(2)]
        table = calibrate_plan(f32_plan, go.params, batches)
        gq = PassManager(("quantize",)).run(go, PassContext(
            calibration=table, quant_skip=APP_QUANT_SKIP[app], act_quant_skip=APP_ACT_SKIP[app]))
        got = {}
        for n in gq.nodes:
            if n.op in ("qconv2d", "qlinear"):
                got[(n.op, n.attrs["scheme"])] = got.get((n.op, n.attrs["scheme"]), 0) + 1
        check(got == schemes, f"{app}: quantized nodes {got}, want {schemes}")
        plan = compile_plan(gq, backend="quant", device="cuda")
        qref_plan = compile_plan(gq, backend="reference", device="cuda")

        run = serve_measured(torch, ops, plan, gq.params, frames, app)
        calls = run["calls"]
        check_per_call(app, run["counts"], calls, {
            "conv2d": sum(conv_by_scheme.values()), "quant_matmul": n_quant,
            "dense_matmul": n_dense, "fused_elementwise": n_fused})
        for scheme, n in conv_by_scheme.items():
            name = "conv2d" if scheme == "f32" else f"conv2d_{scheme}"
            check(run["launches"][name] == n * calls,
                  f"{app}: conv kernel launched {run['launches'][name]} times as {scheme} "
                  f"over {calls} plan calls, want {n} per call")
        for name, n in run["launches"].items():
            launches[name] += n

        # every quantized step: its kernel handler against its reference
        # handler on the same inputs (the values of one plan call)
        values = {}
        x = frames[:BATCH]
        plan.run_steps(gq.params, x, observer=values.__setitem__)
        ref_handlers = qref_plan._handlers
        step_err = 0.0
        for step in plan.steps:
            n = step.node
            if n.op not in ("qconv2d", "qlinear"):
                continue
            xs = [values[i] for i in n.inputs]
            y = plan._handlers[n.op](gq.params[n.name], xs, n.attrs, plan._rt)
            r = ref_handlers[n.op](gq.params[n.name], xs, n.attrs, qref_plan._rt)
            e = (y - r).abs().max().item()
            tol = 1e-3 * max(1.0, r.abs().max().item())
            check(e <= tol, f"{app}: step {n.name} ({n.attrs['scheme']}) kernel vs reference "
                            f"{e} > {tol}")
            step_err = max(step_err, e)
        del values

        out = run["out"]
        check(bool(torch.isfinite(out).all()), f"{app}: non-finite output")
        chunks = range(0, FRAMES, BATCH)
        qref = torch.cat([qref_plan(gq.params, frames[i:i + BATCH]) for i in chunks])
        f32 = torch.cat([f32_plan(go.params, frames[i:i + BATCH]) for i in chunks])
        check(tuple(out.shape) == tuple(qref.shape) == tuple(f32.shape),
              f"{app}: shape {tuple(out.shape)}")
        err_q = (out - qref).abs().max().item()
        # W8 keeps f32 activations: the plan is as close to its reference as
        # an f32 plan is.  W8A8 (coloring) may round an activation the other
        # way after a different f32 sum; its bound is the INT8 contract.
        rtol = 5e-2 if any(s == "w8a8" for _, s in schemes) else 1e-3
        tol_q = rtol * max(1.0, qref.abs().max().item())
        check(err_q <= tol_q, f"{app}: max|quant plan - quant reference plan| {err_q} > {tol_q}")
        err_f = (out - f32).abs().max().item()
        shp = (BATCH, *shape[1:])
        mem_f, mem_q = f32_plan.memory_estimate(shp), plan.memory_estimate(shp)
        sec = run["sec"]
        print(f"  {app:16s} int8 nodes={sum(schemes.values())} "
              f"schemes={ {f'{o}/{s}': k for (o, s), k in schemes.items()} } "
              f"per-call launches conv2d={conv_by_scheme} quant_matmul={n_quant} "
              f"dense_matmul={n_dense} fused_elementwise={n_fused} fallbacks=0 "
              f"step_max_err={step_err:.3e} max_err_vs_quant_ref={err_q:.3e} (tol {tol_q:.1e}) "
              f"max_err_vs_f32={err_f:.3e} weights {mem_f['param_bytes'] / 1e6:.3f}MB -> "
              f"{mem_q['param_bytes'] / 1e6:.3f}MB "
              f"({mem_f['param_bytes'] / mem_q['param_bytes']:.2f}x) "
              f"ms/frame={sec / FRAMES * 1e3:.3f} frames/s={FRAMES / sec:.1f} "
              f"(f32 plan {apps[app]['ms_per_frame']:.3f} ms/frame) "
              f"peak_alloc={run['peak'] / 1e6:.1f}MB")
        profile_serving(torch, app + " int8", run["serve"])
        apps[app].update(gq=gq, int8_plan=plan, int8_out=out, int8_ms=sec / FRAMES * 1e3)
    return launches


def phase_tune(torch, apps):
    """The tuning path on the card: ``launch/tune`` for the three apps with
    ``--quantize`` at the served shapes, then each app's f32 and INT8 plans
    (built by the apps and int8 phases from the same seed, so they resolve
    the same keys) served on the loaded winners and on depth-pinned
    entries.  Every serving's outputs must be ``torch.equal`` to the untuned
    plan's: every tile and depth sums each output in the same order."""
    import contextlib
    import io

    from repro_torch.kernels import _build, ops
    from repro_torch.launch import tune

    cache = ops.tuning_cache()
    out_dir = ROOT / "build" / "tune"
    path = out_dir / "tuning_cache.json"
    argv = ["--graph-app", "all", "--quantize", "--size", str(SIZE), "--base", str(BASE),
            "--batch", str(BATCH), "--seed", str(SEED), "--device", "cuda", "--out", str(path)]
    # the CLI as a fresh process runs it: from an empty cache (the earlier
    # phases recorded their keys' defaults)
    cache.clear()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        tune.main(argv)
    dt = time.perf_counter() - t0
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "report.txt").write_text(buf.getvalue())
    print(f"  python -m repro_torch.launch.tune {' '.join(argv)}: {dt:.1f}s "
          f"(report in {(out_dir / 'report.txt').relative_to(ROOT)})")
    print("  " + buf.getvalue().strip().splitlines()[-1])
    def default_tile(key):
        """The tile the wrapper would run for ``key`` untuned."""
        op, dims, _, fmt, _ = key.split("|")
        d = [int(v) for v in dims.split("x")]
        if op in ("matmul", "qmatmul"):
            return _build.gemm_default_tile(d[1])
        if op == "conv2d":  # fmt is {format}+{scheme}[+...]
            return _build.conv_default_tile(fmt.split("+")[1], d[4])
        return ops.TuningCache.CANDIDATES[op][0]

    fams = {}
    for key, e in cache.entries.items():
        op = key.split("|")[0]
        check(key.endswith("|sm90"), f"tune: key {key} is not an sm90 key")
        if op in ("matmul", "qmatmul", "conv2d"):
            check(e.source == "swept", f"tune: {key} was not swept ({e.source})")
        f = fams.setdefault(op, {"keys": 0, "depth>=2": 0, "not default": 0, "winners": {}})
        f["keys"] += 1
        tile = "x".join(map(str, e.blocks))
        f["winners"][tile] = f["winners"].get(tile, 0) + 1
        f["not default"] += tuple(e.blocks) != default_tile(key)
        if op in ("matmul", "qmatmul") and e.blocks[3] >= 2:
            f["depth>=2"] += 1
    for op, f in sorted(fams.items()):
        st = cache.stats.get(op, {})
        print(f"  tune {op}: {f['keys']} keys, {st.get('sweeps', 0)} sweeps, "
              f"{f['not default']} winners other than the default tile, {f['depth>=2']} "
              f"pipelined; winners by tile {f['winners']}")
    for op in ("matmul", "qmatmul", "conv2d"):
        check(fams.get(op, {}).get("keys", 0) > 0, f"tune: no {op} key")

    launches = {name: 0 for name in KERNELS}

    def serve_all(label, per_call_fn):
        """Serve every app's f32 and INT8 plans on the cache as it stands;
        outputs equal to the untuned plans', exact launches per call."""
        for app, (_, n_conv, n_dense, n_fused) in EXPECTED.items():
            a = apps[app]
            _, conv_by_scheme, n_quant, n_dense_q, n_fused_q = EXPECTED_INT8[app]
            variants = (
                ("f32", a["plan"], a["go"].params, a["out"], a["ms_per_frame"],
                 dict(conv2d=n_conv, dense=n_dense, quant=0, fused_elementwise=n_fused)),
                ("int8", a["int8_plan"], a["gq"].params, a["int8_out"], a["int8_ms"],
                 dict(conv2d=sum(conv_by_scheme.values()), dense=n_dense_q, quant=n_quant,
                      fused_elementwise=n_fused_q)),
            )
            for variant, plan, params, untuned, untuned_ms, n in variants:
                cache.stats.clear()
                run = serve_measured(torch, ops, plan, params, a["frames"], app)
                for fam in ("matmul", "qmatmul", "conv2d"):
                    misses = cache.stats.get(fam, {}).get("misses", 0)
                    check(misses == 0, f"{label} {app} {variant}: {misses} {fam} cache misses")
                check(torch.equal(run["out"], untuned),
                      f"{label} {app} {variant}: output differs from the untuned plan's")
                check_per_call(f"{label} {app} {variant}", run["counts"], run["calls"],
                               per_call_fn(n))
                for kind in ("dense", "quant"):  # each GEMM node: tiled or pipelined
                    c = run["counts"]
                    got = c[f"{kind}_matmul"] + c[f"{kind}_matmul_pipelined"]
                    check(got == n[kind] * run["calls"],
                          f"{label} {app} {variant}: {got} {kind} GEMM launches over "
                          f"{run['calls']} plan calls, want {n[kind]} per call")
                for name, k in run["launches"].items():
                    launches[name] += k
                counts = {k: v // run["calls"] for k, v in run["counts"].items() if v}
                ms = run["sec"] / FRAMES * 1e3
                print(f"  {label:9s} {app:16s} {variant:4s} ms/frame={ms:.3f} "
                      f"(untuned {untuned_ms:.3f}) per-call launches {counts} "
                      f"output torch.equal to the untuned plan's; cache misses 0")

    # 2. the loaded winners: the GEMM nodes run the tiled or the pipelined
    # kernel, whichever won
    cache.clear()
    cache.enabled = False
    cache.ops_filter = None
    cache.load(str(path))
    serve_all("tuned", lambda n: {
        "conv2d": n["conv2d"], "fused_elementwise": n["fused_elementwise"]})
    # 3. every matmul / qmatmul entry replaced by a depth-2, then a depth-3
    # tile: each GEMM node launches the pipelined kernel, none the tiled one
    for depth in (2, 3):
        cache.clear()
        cache.load(str(path))
        for key, e in cache.entries.items():
            if key.split("|")[0] in ("matmul", "qmatmul"):
                e.blocks = (64, 64, 16, depth)
        serve_all(f"depth {depth}", lambda n: {
            "conv2d": n["conv2d"], "fused_elementwise": n["fused_elementwise"],
            "dense_matmul": 0, "dense_matmul_pipelined": n["dense"],
            "quant_matmul": 0, "quant_matmul_pipelined": n["quant"]})
    # 4. back to no tuning and an empty cache
    cache.clear()
    cache.enabled = False
    return launches


#: kernel-name fragments of the port's own kernels
_OWN = {"conv2d_igemm": "conv2d", "dense_matmul_kernel": "dense_matmul",
        "DenseEpilogue": "dense_matmul", "fused_ew": "fused_elementwise",
        "quant_matmul_kernel": "quant_matmul", "flash_attention_kernel": "flash_attention",
        "ffn_gateup_kernel": "ffn_gateup", "GateUpEpilogue": "ffn_gateup",
        "bsr_matmul_kernel": "bsr_matmul", "pipelined_gemm_kernel": "gemm_pipelined",
        "Memcpy": "memcpy"}
#: the conv kernel's first template argument is its scheme (csrc/scheme.cuh)
_CONV_SCHEME = {"0": "conv2d", "1": "conv2d_w8", "2": "conv2d_w8a8"}


def _family(key: str) -> str:
    name = next((v for k, v in _OWN.items() if k in key), None)
    if name == "conv2d":
        return _CONV_SCHEME.get(key.split("conv2d_igemm_kernel<")[-1][:1], name)
    return name or "other:" + key.split("(")[0].split("<")[0][:48]


def profile_serving(torch, app, serve, top_n=6):
    """Where one serving run's device time goes (torch.profiler): device
    time per kernel family, and the device's idle share of the wall time
    (inflated by the profiler's own host overhead).  Returns the numbers."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(PROFILE_ATTEMPTS):  # a session may see no device events
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
            name = _family(e.key)
            by[name] = by.get(name, 0.0) + us
        busy = sum(by.values())
        if busy > 0:
            break
    check(busy > 0, f"{app}: the profiler saw no device time")
    top = sorted(by.items(), key=lambda kv: -kv[1])[:top_n]
    parts = " ".join(f"{k}={v / 1e3:.3f}ms({v / busy:.0%})" for k, v in top)
    print(f"    profile {app}: device {busy / 1e3:.3f}ms of wall {wall_us / 1e3:.3f}ms "
          f"(idle {1 - busy / wall_us:.0%}) {parts}")
    return dict(busy_us=busy, wall_us=wall_us, by=by)


def phase_llm(torch, smoke: bool, block=None):
    """The port's ``serve --llm`` path on the card (``repro_torch.launch.
    serve``'s functions, as the CLI runs them): qwen2.5-3b at full width in
    bf16, or its smoke config in f32; weights from a CUDA generator seeded
    with SEED.  With ``block`` (a ``Block`` structure) the same params then
    serve again block-pruned on every q / o projection (see
    :func:`block_pruned_llm`); the full-width pruned run prints its own
    phase header.  Returns the launches of both runs, summed."""
    import argparse

    from repro_torch.launch import serve

    args = argparse.Namespace(smoke=smoke, **LLM_ARGS)
    dev = torch.device(args.device)
    t0 = time.perf_counter()
    llm = serve.build_llm(args, dev)
    torch.cuda.synchronize()
    cfg = llm["cfg"]
    param_b = plan_param_bytes(*llm["plans"].values())
    print(f"  {cfg.name} {cfg.dtype}: {cfg.n_layers} layers d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab} "
          f"params={param_b / 1e9:.3f}GB built in {time.perf_counter() - t0:.1f}s")
    dense = "dense_matmul" if smoke else "dense_matmul_bf16"
    launches, dense_peak = serve_llm_checked(torch, llm, args, smoke, cfg.name,
                                             {dense: 5 * cfg.n_layers})
    if block is not None:
        if not smoke:
            print(f"== llm block-pruned ({cfg.name}, full width, bf16)")
        t0 = time.perf_counter()
        pruned = block_pruned_llm(torch, llm, block)
        torch.cuda.synchronize()
        dense_b = sum(nbytes(lp["attn"]["w_q"]["w"], lp["attn"]["w_o"]["w"])
                      for lp in llm["params"]["layers"])
        # the dense model goes before the pruned one serves: its plans and
        # its q / o weights (the pruned plans share every other tensor), so
        # the pruned run's peak is the pruned plans' own
        del llm
        torch.cuda.empty_cache()
        graph = pruned["plans"]["decode"].graph
        pbcsr = [n for n in graph.nodes
                 if n.op == "sparse_linear" and n.attrs["format"] == "pbcsr"]
        glue = [n.name for n in graph.nodes if n.name.endswith("_unperm")]
        n_bands = sum(len(n.attrs["bands"]) for n in pbcsr)
        check(len(pbcsr) == 2 * cfg.n_layers, f"pruned llm: {len(pbcsr)} pbcsr nodes")
        # the packed q / o weights as the device holds them (pads included)
        packed = sum(nbytes(graph.params[n.name]["values"], graph.params[n.name]["block_rows"])
                     for n in pbcsr)
        blocks = sum(int((graph.params[n.name]["block_rows"] >= 0).sum()) for n in pbcsr)
        pruned_b = plan_param_bytes(*pruned["plans"].values())
        print(f"  {block}: {len(pbcsr)} pbcsr nodes, {n_bands} bands, {len(glue)} unperm glue "
              f"nodes; q/o weights {dense_b / 1e6:.3f}MB dense -> {packed / 1e6:.3f}MB packed "
              f"({blocks} blocks); pruned plans' params {pruned_b / 1e9:.3f}GB (dense "
              f"{param_b / 1e9:.3f}GB); pruned in {time.perf_counter() - t0:.1f}s")
        # the params memory_estimate counts lose at most the q / o bytes the
        # packing saves (the bands' unperm glue, where there is any, adds
        # its index tensors)
        check(0 < param_b - pruned_b <= dense_b - packed,
              f"pruned llm: plan params {pruned_b} B against dense {param_b} B, q/o "
              f"{dense_b} B -> {packed} B")
        if not smoke:  # the paper's balanced recipe: one band a node, no glue,
            # at most half the dense bytes + one int32 per kept block
            check(n_bands == 2 * cfg.n_layers and not glue,
                  f"pruned llm: {n_bands} bands, glue {glue[:4]}")
            check(packed <= 0.5 * dense_b + 4 * blocks,
                  f"pruned llm: q/o packed {packed} B > half of dense {dense_b} B + 4 B/block")
        else:  # the unbalanced smoke variant runs bands, glue and a lone rope
            check(n_bands > len(pbcsr) and glue and any(
                n.op == "rope" for n in graph.nodes), "pruned llm smoke: no bands / glue")
        per_call = {dense: 3 * cfg.n_layers, "bsr_matmul": n_bands}
        pruned_launches, pruned_peak = serve_llm_checked(
            torch, pruned, args, smoke, f"{cfg.name} pruned", per_call, n_glue=len(glue))
        for name, n in pruned_launches.items():
            launches[name] += n
        if not smoke:  # at full width the halved q / o bytes show in the peak
            check(pruned_peak < dense_peak,
                  f"pruned llm: peak {pruned_peak} B, dense {dense_peak} B")
        del pruned
    else:
        del llm
    torch.cuda.empty_cache()
    return launches


def plan_param_bytes(*plans) -> int:
    """The param bytes of ``plans`` as ``memory_estimate`` counts them (every
    leaf of ``plan.graph.params``), a tensor the plans share counted once:
    what the card holds for them."""
    leaves = {}
    for plan in plans:
        for p in plan.graph.params.values():
            for t in p.values():
                leaves[(t.data_ptr(), t.numel(), t.dtype)] = t.numel() * t.element_size()
    return sum(leaves.values())


def block_pruned_llm(torch, llm, block):
    """The compiler's block-pruning path on built params: ``project`` every
    ``q_i`` / ``o_i`` weight onto ``block``, ``optimize`` the decoder graphs
    with those masks (``substitute_sparse`` packs them as PBCSR nodes) and
    compile both phases for the kernel backend.  The returned llm's
    ``params`` are the masked-dense tree, which the plain ``forward`` of
    the parity check runs; its masked q / o weights wait in host memory
    (``params_on_host``) until the parity check, so that the serving run's
    peak is the pruned plans' own."""
    from repro_torch.core.graph import compile_plan
    from repro_torch.core.graph.passes import optimize
    from repro_torch.core.pruning import project
    from repro_torch.models.transformer_graph import build_decoder_graph

    cfg, params, dev = llm["cfg"], llm["params"], llm["device"]
    masks, structures, layers = {}, {}, []
    for i, lp in enumerate(params["layers"]):
        attn = dict(lp["attn"])
        for key, node in (("w_q", f"q_{i}"), ("w_o", f"o_{i}")):
            w, masks[node] = project(attn[key]["w"], block)
            structures[node] = block
            attn[key] = {**attn[key], "w": w.cpu()}
        layers.append({**lp, "attn": attn})
    graphs = {ph: optimize(build_decoder_graph(params, cfg, phase=ph), masks, structures)
              for ph in ("prefill", "decode")}
    # each phase's optimize packs its own copy of every pruned weight: the
    # prefill graph takes the decode graph's (the same bits), so the card
    # holds one copy, as the dense plans share one set of weights
    dec = graphs["decode"].params
    for n in graphs["prefill"].nodes:
        if n.op == "sparse_linear" and n.attrs["format"] == "pbcsr":
            mine, theirs = graphs["prefill"].params[n.name], dec[n.name]
            check(mine.keys() == theirs.keys() and all(
                torch.equal(mine[k], theirs[k]) for k in mine),
                f"pruned llm: {n.name} packs differently in the two phases")
            graphs["prefill"].params[n.name] = theirs
    plans = {ph: compile_plan(g, backend="kernel", device=dev) for ph, g in graphs.items()}
    return dict(cfg=cfg, params={**params, "layers": layers}, graphs=graphs, plans=plans,
                device=dev, params_on_host=True)


def serve_llm_checked(torch, llm, args, smoke, label, per_call, n_glue=0):
    """One warm-up run, one timed run with the launch counts set to 0 just
    before it and read just after (checked per plan call: ``per_call`` plus
    one flash_attention and one ffn_gateup per layer, nothing else), one
    profiled run; then finite prefill logits near the reference plan's and
    the plain ``forward``'s, and greedy parity of every served sequence
    against ``forward`` -- exact in f32, the bf16 near-tie rule of
    ``serve.PARITY_BF16_ULPS`` at full width.  Returns the launches and
    the timed run's peak allocated bytes (beside ``memory_estimate``'s
    figure for the prefill plan at the served prompts)."""
    from repro_torch.core.graph import compile_plan
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.transformer import forward

    cfg, plans, dev = llm["cfg"], llm["plans"], llm["device"]
    n_layers = cfg.n_layers
    steps = {ph: len(p.steps) for ph, p in plans.items()}
    want_steps = 9 * n_layers + 2 + 2 * n_glue
    check(steps == {"prefill": want_steps, "decode": want_steps},
          f"{label}: plan steps {steps}, want {want_steps} each")
    per_call = {**per_call, "flash_attention": n_layers, "ffn_gateup": n_layers}
    prompts = serve.llm_prompts(args, cfg)

    serve.serve_llm_traffic(llm, prompts, args)  # warm-up
    ops.reset_kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    run = serve.serve_llm_traffic(llm, prompts, args)
    launches = main_path_launches(ops)
    peak = torch.cuda.max_memory_allocated()
    st, occ = run["stats"], run["occupancy"]
    calls = st["prefill_batches"] + st["decode_batches"]
    for name, got in launches.items():
        n = per_call.get(name, 0) * calls
        check(got == n, f"{label}: {name} launched {got} times over {calls} plan calls, "
                        f"want {per_call.get(name, 0)} per call")
    check(st["failed"] == 0 and st["completed"] == len(prompts), f"{label}: stats {st}")
    check(occ["used_pages"] == 0, f"{label}: {occ['used_pages']} KV pages leaked")
    toks = sum(len(h.result()) for h in run["handles"])
    check(toks == len(prompts) * args.new_tokens, f"{label}: {toks} tokens served")
    ms_decode = st["decode_seconds"] / st["decode_batches"] * 1e3
    ms_prefill = st["prefill_seconds"] / st["prefill_batches"] * 1e3
    launch_txt = " ".join(f"{k}={v}" for k, v in per_call.items())
    s_max = max(len(p) for p in prompts)
    est = plans["prefill"].memory_estimate(
        torch.zeros(len(prompts), s_max, dtype=torch.int32),
        torch.zeros(len(prompts), s_max, dtype=torch.int32),
        torch.zeros(len(prompts), dtype=torch.int32))
    print(f"  {label}: plan steps prefill={steps['prefill']} decode={steps['decode']}; served "
          f"{len(prompts)} sequences, {toks} tokens in {run['seconds']:.3f}s "
          f"({toks / run['seconds']:.1f} tok/s): {st['prefill_batches']} prefill + "
          f"{st['decode_batches']} decode plan calls, {ms_prefill:.2f} ms/prefill "
          f"{ms_decode:.2f} ms/decode step; per-call launches {launch_txt}; "
          f"failed={st['failed']}; KV pages {occ['num_pages']}x{occ['page_size']} "
          f"peak={occ['peak_used']} leaked={occ['used_pages']}; peak_alloc={peak / 1e9:.3f}GB "
          f"(memory_estimate, prefill of {len(prompts)}x{s_max}: params "
          f"{est['param_bytes'] / 1e9:.3f}GB + activations "
          f"{est['peak_activation_bytes'] / 1e9:.3f}GB = {est['peak_total_bytes'] / 1e9:.3f}GB)")
    check(peak >= est["param_bytes"], f"{label}: peak {peak} B below the params' bytes")
    profile_serving(torch, f"llm {label}",
                    lambda: serve.serve_llm_traffic(llm, prompts, args), top_n=8)
    if llm.pop("params_on_host", False):  # the parity tree back on the card
        llm["params"] = _to_device(llm["params"], dev)

    # correctness: finite prefill logits of the right shape, near the
    # reference backend's and the plain forward's; greedy parity per sequence
    p0 = prompts[0]
    n0 = len(p0)
    inputs = (p0[None], np.arange(n0, dtype=np.int32)[None], np.array([n0], np.int32))
    with torch.no_grad():
        logits = plans["prefill"](plans["prefill"].graph.params, *inputs)[0].float()
        ref_plan = compile_plan(plans["prefill"].graph, backend="reference", device=dev)
        ref = ref_plan(ref_plan.graph.params, *inputs)[0].float()
        fwd = forward(llm["params"], cfg, torch.from_numpy(p0[None]).to(dev))[0].float()
    check(tuple(logits.shape) == (1, n0, cfg.vocab_padded),
          f"{label}: logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
    v = cfg.vocab
    err_ref = (logits[..., :v] - ref[..., :v]).abs().max().item()
    err_fwd = (logits[..., :v] - fwd[..., :v]).abs().max().item()
    top = fwd[..., :v].abs().max().item()
    if smoke:  # f32: the kernels' sums differ from torch's in order only
        check(err_fwd <= 1e-4 * max(1.0, top), f"{label}: prefill vs forward {err_fwd}")
    parity = [serve.greedy_parity(llm, p, [int(t) for t in h.result()])
              for p, h in zip(prompts, run["handles"])]
    if smoke:
        check(all(par["exact"] for par in parity), f"{label}: greedy parity {parity}")
    compared = sum(par["compared"] for par in parity)
    ties = [par["near_tie"] for par in parity if par["near_tie"] is not None]
    tie_txt = "; ".join(f"margin {m:.4f} < {t:.4f}" for m, t in ties) or "none"
    print(f"  prefill logits vs reference plan {err_ref:.3e}, vs plain forward {err_fwd:.3e} "
          f"(max|logit| {top:.3f}); greedy parity ok: {compared}/{toks} tokens compared and "
          f"equal to the plain forward loop (exact={all(par['exact'] for par in parity)}; "
          f"near-ties: {tie_txt}; smallest top-2 margin "
          f"{min(par['min_margin'] for par in parity):.4f}); teacher-forced: every served "
          f"token within {max(par['max_forced_gap'] for par in parity):.4f} of forward's best "
          f"logit (tolerance {'0 (f32)' if smoke else f'{serve.PARITY_BF16_ULPS} bf16 ulps'})")
    del ref_plan
    return launches, peak


def _to_device(tree, dev):
    """``tree`` (dicts, lists, tuples of tensors and other leaves) with every
    tensor on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, dev) for v in tree)
    return tree.to(dev) if hasattr(tree, "to") and hasattr(tree, "device") else tree


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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every phase before the tune phase runs untuned, whatever REPRO_TUNE /
    # REPRO_TUNE_CACHE say: tuning off, an empty cache
    from repro_torch.kernels import ops

    cache = ops.tuning_cache()
    cache.clear()
    cache.enabled = False
    cache.path = None
    cache.ops_filter = None

    print("== device")
    phase_device(torch)
    print("== build")
    phase_build()
    print("== kernels")
    results = phase_kernels(torch)
    phase_llm_kernels(torch, results)
    print(f"== apps (base={BASE}, {FRAMES} frames of {SIZE}x{SIZE}, batch {BATCH})")
    launches, apps = phase_apps(torch, np)
    print(f"== int8 apps (base={BASE}, {FRAMES} frames of {SIZE}x{SIZE}, batch {BATCH})")
    int8_launches = phase_int8(torch, np, apps)
    for name, n in int8_launches.items():
        launches[name] += n
    print(f"== tune (base {BASE}, {SIZE}x{SIZE}, batch {BATCH})")
    for name, n in phase_tune(torch, apps).items():
        launches[name] += n
    del apps
    from repro_torch.core.pruning import Block

    print("== llm smoke (f32)")
    for name, n in phase_llm(torch, True, Block(0.5, bm=32, bn=32, balanced=False)).items():
        launches[name] += n
    print("== llm (qwen2.5-3b, full width, bf16)")
    # the paper's attention recipe (the JAX package's launch/train.py:47-48)
    for name, n in phase_llm(torch, False, Block(0.5, bm=64, bn=64)).items():
        launches[name] += n
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
