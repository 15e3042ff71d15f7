#!/usr/bin/env python3
"""Check and time the f32 / INT8 GEMM kernels of one source tree on the card.

    python3 tools/gemm_bench.py [--src DIR] [--label NAME] [--gemm-only] [--sweep]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (by
default this repository's; another checkout's times that tree in the same
run, its kernels built into its own ``build/``).  ``--gemm-only`` builds
just the four GEMM sources (``dense_matmul*.cu``, ``quant_matmul*.cu``)
into ``build/gemm_only/`` and binds those entry points: a shorter build for
a first look at a changed GEMM.  Prints the card's name and power limit and
the registers and spills of every f32 / INT8 GEMM instance from the build
log, then per case: the largest error against the plain version with its
tolerance (1e-4 x max(1, max|plain|) for f32 / W8, 1e-5 for W8A8), whether
every tile and depth is ``torch.equal`` to the default tile (and, on trees
with the NCHW layout, the NCHW output to the row-major one permuted), and
device ms by CUDA events (20 calls after 3): the kernel at depth 1, 2 and
3, and the library call (``torch.addmm``, ``torch._int_mm`` + rescale, or
``F.conv2d`` with TF32 off for the NCHW cases).  ``--sweep`` instead times
the f32 kernel alone at M = 4 * 256^2 over K (0..64; K = 0 runs one
zero-filled slab) and N (64 on the default tile, 192 on every depth-1
tile), both layouts, beside a store-only and a read-write pass over the
output (``fill_``, ``relu_``): where the time goes.  A failed check prints
``FAIL``; the script exits 1 after the last case.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_GEMM_SOURCES = ("dense_matmul.cu", "dense_matmul_pipelined.cu", "quant_matmul.cu",
                 "quant_matmul_pipelined.cu")
_WATCHED = ("simt_gemm_kernel", "int8_gemm_kernel", "dense_matmul_kernel",
            "quant_matmul_kernel", "pipelined_gemm_kernel")


def gemm_only_library(_build):
    """Build the GEMM sources alone and bind their entry points as the
    package's library (the other entry points stay unbound)."""
    out = _build.REPO_ROOT / "build" / "gemm_only" / _build.source_hash()
    lib_path = out / "libgemm.so"
    if not lib_path.exists():
        out.mkdir(parents=True, exist_ok=True)
        procs = [subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-c",
             str(_build.CSRC / src), "-o", str(out / (src + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for src in _GEMM_SOURCES]
        logs = [p.communicate()[0] for p in procs]
        (out / "build.log").write_text("\n".join(logs))
        if any(p.returncode for p in procs):
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        subprocess.run([_build._nvcc(), *_build.GENCODE, "-shared", "-o", str(lib_path),
                        *[str(out / (src + ".o")) for src in _GEMM_SOURCES]], check=True)
    cdll = ctypes.CDLL(str(lib_path))

    class Partial:  # _bind types every entry point: stand-ins for those not built
        def __getattr__(self, name):
            try:
                return getattr(cdll, name)
            except AttributeError:
                return self.__dict__.setdefault(name, types.SimpleNamespace())

    _build._bind(Partial())
    _build._LIB = cdll
    return lib_path


def registers(log_path: Path) -> None:
    entry = None
    for line in log_path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if any(k in m.group(1) for k in _WATCHED) else None
        regs = re.search(r"Used (\d+) registers", line)
        if entry and (regs or ("spill" in line and " 0 bytes spill" not in line)):
            print(f"  ptxas {entry[:90]}: {line.split('ptxas info    :')[-1].strip()}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--gemm-only", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("gemm_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import dense_matmul as kdense
    from repro_torch.kernels import dense_matmul_pipelined as kdense_pipe
    from repro_torch.kernels import quant_matmul as kquant
    from repro_torch.kernels import quant_matmul_pipelined as kquant_pipe
    from repro_torch.kernels.ref import _ACT
    from repro_torch.quant import QTensor, quantize_array

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"== {args.label} ({args.src}) on {smi}")
    if args.gemm_only:
        path = gemm_only_library(_build)
    else:
        path = _build.build()
        _build.lib()
    registers(path.parent / "build.log")
    nchw = hasattr(_build, "LAYOUT_CODES")
    cache = ops.tuning_cache()
    cache.clear()
    cache.enabled = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    failed = []

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def ms(fn, reps=20):
        for _ in range(3):
            fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def verdict(ok, what):
        if not ok:
            failed.append(what)
        return "ok" if ok else "FAIL"

    def case(label, m, k, n, scheme, act=None, sides_epi=False, img=None):
        """A GEMM of M = m rows (or, with ``img`` = (nb, h, w), the 1x1 conv
        over nb images of h x w pixels)."""
        if img is not None:
            nb, h, w_ = img
            m = nb * h * w_
        x = randn(m, k)
        wf = randn(k, n, scale=k ** -0.5)
        b = randn(n, scale=0.1)
        sides = (randn(m, n), randn(m, n)) if sides_epi else ()
        epi = (("add", 0), ("mul", 1)) if sides_epi else ()
        kw = dict(activation=act, epilogue=epi)
        if scheme == "f32":
            wk, ws, tiled, piped, plain = wf, None, kdense.dense_matmul, \
                kdense_pipe.dense_matmul_pipelined, kdense.dense_matmul_plain
        else:
            qt = QTensor.from_float(wf, axis=1)
            wk, ws = qt.values, qt.scale
            if scheme == "w8a8":
                x_scale = torch.full((1,), x.abs().max().item() / 127.0, device=dev)
                x, ws = quantize_array(x, x_scale), ws * x_scale
            tiled, piped, plain = kquant.quant_matmul, kquant_pipe.quant_matmul_pipelined, \
                kquant.quant_matmul_plain
        pre = () if ws is None else (ws,)

        def run(t, *xs, **extra):
            fn = tiled if t[3] == 1 else piped
            more = {} if t[3] == 1 else {"depth": t[3]}
            return fn(xs[0], xs[1], *pre, b, *xs[2:], **kw, **extra, **more, block_m=t[0],
                      block_n=t[1], block_k=t[2])

        out = (tiled(x, wk, *pre, b, *sides, **kw))
        want = plain(x, wk, *pre, b, *sides, **kw)
        err = (out - want).abs().max().item()
        tol = (1e-5 if scheme == "w8a8" else 1e-4) * max(1.0, want.abs().max().item())
        exact = torch.equal(out, want)
        d = _build.gemm_default_tile(n)
        eq_tiles = all(torch.equal(run(t, x, wk, *sides), out) for t in _build.GEMM_TILES)
        t1 = ms(lambda: tiled(x, wk, *pre, b, *sides, **kw))
        t2 = ms(lambda: run((*d[:3], 2), x, wk, *sides))
        t3 = ms(lambda: run((*d[:3], 3), x, wk, *sides))
        if scheme == "f32":
            lib = lambda: _ACT[act](torch.addmm(b, x, wf))  # noqa: E731
        elif scheme == "w8":
            w_deq = wk.float() * ws
            lib = lambda: _ACT[act](torch.addmm(b, x, w_deq))  # noqa: E731
        elif m > 16 and k % 8 == 0 and n % 8 == 0:
            lib = lambda: _ACT[act](torch._int_mm(x, wk).float() * ws + b)  # noqa: E731
        else:
            lib = None
        lib_ms = "n/a" if lib is None else f"{ms(lib):.4f}"
        line = (f"  {scheme:5s} row  {label:34s} err={err:.2e} (tol {tol:.1e}, "
                f"{verdict(err <= tol and (exact or scheme != 'w8a8'), label + ' plain')}"
                f"{', equal' if exact else ''}) tiles/depths "
                f"{verdict(eq_tiles, label + ' tiles')}  d1={t1:.4f} d2={t2:.4f} d3={t3:.4f} "
                f"library={lib_ms} ms")
        print(line)
        if img is None or not nchw:
            return
        # the same product as a 1x1 conv: NCHW in and out, through ops
        nb, h, w_ = img
        x4 = x.reshape(nb, h, w_, k).permute(0, 3, 1, 2).contiguous()
        s4 = [s.reshape(nb, h, w_, n).permute(0, 3, 1, 2).contiguous() for s in sides]
        wn = wk.t().contiguous()  # [N, K]
        want4 = out.reshape(nb, h, w_, n).permute(0, 3, 1, 2)
        got4 = tiled(x4, wn, *pre, b, *s4, **kw, _layout="nchw")
        eq4 = torch.equal(got4, want4)
        eq4_tiles = all(torch.equal(run(t, x4, wn, *s4, _layout="nchw"), want4)
                        for t in _build.GEMM_TILES)
        n1 = ms(lambda: tiled(x4, wn, *pre, b, *s4, **kw, _layout="nchw"))
        n2 = ms(lambda: run((*d[:3], 2), x4, wn, *s4, _layout="nchw"))
        n3 = ms(lambda: run((*d[:3], 3), x4, wn, *s4, _layout="nchw"))
        wconv = (wf.t() if scheme == "f32" else wk.t().float() * ws[:, None])
        wconv = wconv.contiguous()[:, :, None, None]
        x4f = x4.float() if scheme != "w8a8" else None
        conv_ms = "n/a"
        if x4f is not None:
            conv_ms = f"{ms(lambda: _ACT[act](F.conv2d(x4f, wconv, b))):.4f}"
        print(f"  {scheme:5s} nchw {label:34s} equal to row permuted "
              f"{verdict(eq4, label + ' nchw')}, tiles/depths "
              f"{verdict(eq4_tiles, label + ' nchw tiles')}  d1={n1:.4f} d2={n2:.4f} "
              f"d3={n3:.4f} F.conv2d={conv_ms} ms")

    big = (4, 256, 256)
    if args.sweep:
        m = 4 * 256 * 256
        for n in (64, 192):
            y = torch.empty(m, n, device=dev)
            print(f"  sweep N={n:3d} fill_={ms(lambda: y.fill_(1.0)):.4f} "
                  f"relu_={ms(lambda: y.relu_()):.4f} ms")
            for k in (0, 8, 16, 32, 64):
                x, w = randn(m, k), randn(k, n, scale=max(k, 1) ** -0.5)
                x4 = x.reshape(4, 256, 256, k).permute(0, 3, 1, 2).contiguous()
                wn = w.t().contiguous()
                tiles = [t for t in _build.GEMM_TILES if t[3] == 1] if n == 192 else []
                for t in tiles or [None]:
                    pin = {} if t is None else dict(block_m=t[0], block_n=t[1], block_k=t[2])
                    row = ms(lambda: kdense.dense_matmul(x, w, activation="relu", **pin))
                    nc = "n/a"
                    if nchw:
                        t_n = ms(lambda: kdense.dense_matmul(x4, wn, activation="relu",
                                                             _layout="nchw", **pin))
                        nc = f"{t_n:.4f}"
                    tl = "default" if t is None else "x".join(map(str, t[:3]))
                    print(f"  sweep N={n:3d} K={k:2d} tile {tl:9s} row={row:.4f} nchw={nc} ms")
        return 0
    case("M=4*256^2 K=32 N=192 relu", 0, 32, 192, "f32", act="relu", img=big)
    case("M=1000 K=50 N=70 add+mul", 1000, 50, 70, "f32", sides_epi=True)
    case("M=2*37x29 K=70 N=50 add+mul", 0, 70, 50, "f32", sides_epi=True, img=(2, 37, 29))
    case("M=2*16x8 K=24 N=40 relu", 0, 24, 40, "f32", act="relu", img=(2, 16, 8))
    case("M=4*256^2 K=32 N=192 relu", 0, 32, 192, "w8", act="relu", img=big)
    case("M=2*37x29 K=70 N=50 add+mul", 0, 70, 50, "w8", sides_epi=True, img=(2, 37, 29))
    case("M=4*64^2 K=128 N=64 relu", 0, 128, 64, "w8a8", act="relu", img=(4, 64, 64))
    case("M=2*37x29 K=70 N=50 add+mul", 0, 70, 50, "w8a8", sides_epi=True, img=(2, 37, 29))
    case("M=2*16x8 K=64 N=40 add", 0, 64, 40, "w8a8", sides_epi=True, img=(2, 16, 8))
    case("M=4 K=64 N=64 relu", 4, 64, 64, "w8a8", act="relu")
    if failed:
        print(f"gemm_bench: {len(failed)} checks failed: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
