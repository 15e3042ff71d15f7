#!/usr/bin/env python3
"""Where the TMA + wgmma body's time goes, and the kernels that run it at
decode and on block-sparse weights, on one or two source trees on the card.

    python3 tools/wgmma_bench.py [--floor] [--decode] [--bsr] [--src OTHER_SRC]
                                 [--gemm-only]

Each tree is loaded as ``tools/gemm_bench.py --bf16`` loads it (``--src``:
another checkout's ``src``, its parent say, timed in the same process,
calls in the order parent, this, this, parent; without it this tree twice);
device ms by torch.profiler (20 calls after 3), as ``PERF.md`` §6 times
every kernel.  The card's name and power limit come first.

``--floor`` breaks the body's fixed cost a launch down:

* (a) launch alone: empty kernels (``tools/launch_floor.cu``) with the
  body's grid at qwen2.5-3b's q shape (32 N tiles x 6 K ranges = 192 CTAs
  of 160 threads), its cluster of 6 along z and its dynamic shared memory;
  without the cluster attribute; without shared memory; one CTA; and the
  body's two cluster barriers alone;
* (b) ramp and drain: the body with one 128-row slab a CTA (M = 48 and 3,
  2048 -> K = 768 in 6 ranges, tile 64 x 64 x 128), and with two 64-row
  slabs (tile 64 x 64 x 64) on the same grid;
* (c) the cluster's part: q (M = 48 and 3, 2048 -> 2048) with its K split
  forced to 1, 2, 4, the plan's and 8 ranges (``_build.tma_plan`` patched
  in the tool, never a switch in the package);
* (d) the curve: M = 48 and 3, N = 2048, K = 256 / 1024 / 2048 / 11008
  (1 / 4 / 8 / 45 MB of weight) at each tree's plan, beside ``torch.addmm``;
  a least-squares line through each gives the fixed us and the streaming
  rate (TB/s).

Every body launch of (b)-(d) names its tile, so it runs the wgmma body on
every tree whatever the tree's route at that M.

``--decode`` times the 12 served decode projections (q, k/v, o, down of
qwen2.5-3b, granite-3-2b, phi4-mini-3.8b at M = 3): each tree's own route
(``route_launches``), this tree's wgmma body under other tiles and K splits
(``tBMxBNxBK:nsS``, ``_build.tma_plan`` patched), ``torch.addmm`` (+ the
side), the byte bound at 3.35 TB/s, the largest error against the plain
version (one bf16 ulp of max|plain|), then each decoder's dense ms per
decode plan call (layers x (q + 2 k/v + o + down)).

``--bsr`` times ``bsr_matmul`` at qwen2.5-3b's block-pruned q / o
(``Block(0.5, 64, 64)``, 2048 -> 2048, 32 block-columns of 16 steps) at
decode (M = 3) and prefill (M = 48): each tree's route and split
(``plan_for``), device ms, ``torch.addmm`` on the unpacked dense weight (+
the side), the byte bound of the packed blocks, the error against
``bsr_matmul_plain``; this tree's split target swept (its
``TMA_TARGET``: two CTAs an SM, one, no split) and, at decode, its
streaming route beside the wgmma one (``tma_bk`` patched to refuse the
blocks); then a
block-pruned plan call's 72 launches a phase (36 q + 36 o).

``--gemm-only`` builds just the GEMM sources (and ``bsr_matmul.cu`` with
``--bsr``) into ``build/gemm_only/``.  A failed check prints ``FAIL``; the
script exits 1 after the last case.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import gemm_bench as gb  # noqa: E402

_PEAK_BYTES_PER_S = 3.35e12


def load(src: str, bsr: bool):
    """``gemm_bench.load_tree`` and, with ``bsr``, the tree's block-sparse
    modules (imported before the next tree replaces ``sys.modules``)."""
    t = gb.load_tree(src)
    if bsr:
        from repro_torch.core.pruning import Block, project
        from repro_torch.core.sparse import PBCSR
        from repro_torch.kernels import bsr_matmul as kbsr

        t.bsr, t.Block, t.project, t.PBCSR = kbsr, Block, project, PBCSR
        t.modules = gb._tree_modules()
    return t


@contextlib.contextmanager
def patched(mod, **values):
    """``mod``'s attributes replaced while the block runs."""
    real = {name: getattr(mod, name) for name in values}
    for name, v in values.items():
        setattr(mod, name, v)
    try:
        yield
    finally:
        for name, v in real.items():
            setattr(mod, name, v)


def ranges(k: int, ns: int):
    """``(kchunk, ns)``: ``ns`` K ranges of whole 128-row steps, or None
    where K does not hold that many."""
    kc = -(-(-(-k // ns)) // 128) * 128
    return (kc, ns) if -(-k // kc) == ns else None


def floor_library(build):
    """Build ``tools/launch_floor.cu`` (seconds: no PyTorch headers)."""
    out = build.REPO_ROOT / "build" / "launch_floor"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "liblaunch_floor.so"
    subprocess.run([build._nvcc(), *build.GENCODE, "-std=c++17", "-O3", "-shared", "-Xcompiler",
                    "-fPIC", "-o", str(lib), str(ROOT / "tools" / "launch_floor.cu")], check=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.floor_launch.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    cdll.floor_launch.restype = ctypes.c_int
    return cdll


def fit(points):
    """Least-squares ``t = a + bytes / rate`` through ``(bytes, ms)``:
    ``(a in us, rate in TB/s)``."""
    xs, ys = [p[0] for p in points], [p[1] for p in points]
    mx, my = statistics.fmean(xs), statistics.fmean(ys)
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sum((x - mx) ** 2 for x in xs)
    return (my - slope * mx) * 1e3, (1e3 / slope / 1e12) if slope > 0 else float("inf")


def floor_bench(torch, trees, order, randn) -> None:
    """The --floor mode (module doc)."""
    this = trees["this"]
    lib = floor_library(this.build)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    tile = (64, 64, 64, 1)
    shape = this.build.wgmma_shape(tile)
    smem, threads = shape["smem"], shape["threads"]
    print(f"  (a) launch alone, grid 1 x 32 x 6 = 192 CTAs of {threads} threads "
          f"(qwen q's), ms:")
    for label, args in (
            ("cluster 6, ring smem", (1, 32, 6, 6, threads, smem, 0)),
            ("no cluster, ring smem", (1, 32, 6, 0, threads, smem, 0)),
            ("no cluster, no smem", (1, 32, 6, 0, threads, 0, 0)),
            ("one CTA, no smem", (1, 1, 1, 0, threads, 0, 0)),
            ("cluster 6, ring smem, two cluster barriers", (1, 32, 6, 6, threads, smem, 1))):
        def launch(args=args):
            err = lib.floor_launch(*args, stream())
            if err:
                raise RuntimeError(f"floor_launch{args}: CUDA error {err}")
        print(f"      {label:44s} {gb.device_ms(torch, launch):.4f}")

    def body(t, m, k, n, tl, plan=None):
        """Device ms of this shape through ``t``'s wgmma body, tile ``tl``
        named, K ranges ``plan`` (None: the tree's own), in ``order``."""
        x, w = randn(m, k), randn(k, n, scale=k ** -0.5)
        pins = dict(block_m=tl[0], block_n=tl[1], block_k=tl[2])
        fn = lambda: t.dense.dense_matmul(x, w, **pins)  # noqa: E731
        with patched(t.build, tma_plan=(lambda *_: plan) if plan else t.build.tma_plan):
            before = dict(t.dense.route_launches)
            fn()
            ran = [r for r, c in t.dense.route_launches.items() if c != before[r]]
            if ran != ["wgmma"]:
                raise RuntimeError(f"floor: {m}x{k}x{n} ran {ran}")
            return gb.device_ms(torch, fn)

    def per_tree(fn):
        res = {}
        for name in order:
            res.setdefault(name, []).append(fn(trees[name]))
        return {name: sum(v) / len(v) for name, v in res.items()}

    def show(label, res, extra=""):
        print(f"      {label:44s} " + " ".join(f"{k}={v:.4f}" for k, v in res.items()) + extra)

    for m in (48, 3):
        print(f"  (b) ramp and drain, M={m}, 2048 -> K=768 in 6 ranges (192 CTAs), ms:")
        show("one 128-row slab a CTA (64x64x128)",
             per_tree(lambda t: body(t, m, 768, 2048, (64, 64, 128, 1), (128, 6))))
        show("two 64-row slabs a CTA (64x64x64)",
             per_tree(lambda t: body(t, m, 768, 2048, (64, 64, 64, 1), (128, 6))))
        print(f"  (c) the cluster's part, q M={m} 2048 -> 2048, ms by K ranges:")
        for ns in (1, 2, 4, 6, 8):
            show(f"ns {ns} ({32 * ns} CTAs)",
                 per_tree(lambda t: body(t, m, 2048, 2048, tile, ranges(2048, ns))))
        print(f"  (d) the curve, M={m}, N=2048, each tree's plan, ms:")
        pts, lib_pts = {}, []
        for k in (256, 1024, 2048, 11008):
            res = per_tree(lambda t: body(t, m, k, 2048, tile))
            x, w = randn(m, k), randn(k, 2048, scale=k ** -0.5)
            lib_ms = gb.device_ms(torch, lambda: torch.matmul(x, w))
            wbytes = k * 2048 * 2
            for name, v in res.items():
                pts.setdefault(name, []).append((wbytes, v))
            lib_pts.append((wbytes, lib_ms))
            show(f"K={k} ({wbytes / 2 ** 20:.0f} MB)", res, f" matmul={lib_ms:.4f}")
        for name, p in {**pts, "torch.matmul": lib_pts}.items():
            a, rate = fit(p)
            print(f"      fit {name:16s} fixed {a:.2f} us, {rate:.2f} TB/s")


def decode_bench(torch, trees, order, randn, failed) -> None:
    """The --decode mode (module doc)."""
    this = trees["this"]
    per_call = {}
    tiles = [t for t in this.build.BF16_GEMM_TILES if t[0] == 64 and t[3] == 1]
    for arch in gb._DECODERS:
        c = this.get_config(arch)
        d, dh, h, g, f = c.d_model, c.resolved_head_dim, c.n_heads, c.n_kv_heads, c.d_ff
        rows = {}
        for role, k, n, add in (("q", d, h * dh, False), ("kv", d, g * dh, False),
                                ("o", h * dh, d, True), ("down", f, d, True)):
            m = 3
            x, w = randn(m, k), randn(k, n, scale=k ** -0.5)
            b = randn(n, scale=0.1) if c.qkv_bias and not add else None
            sides = (randn(m, n),) if add else ()
            kw = dict(epilogue=(("add", 0),) if add else ())
            want = this.dense.dense_matmul_plain(x, w, b, *sides, **kw).float()
            tol = this.ulp(want.abs().max().item())
            bodies, errs = {}, []
            for name, t in trees.items():
                before = dict(t.dense.route_launches)
                out = t.dense.dense_matmul(x, w, b, *sides, **kw)
                torch.cuda.synchronize()
                bodies[name] = ",".join(r for r, v in t.dense.route_launches.items()
                                        if v != before[r])
                errs.append((out.float() - want).abs().max().item())
            times = {}
            for name in order:
                t = trees[name]
                times.setdefault(name, []).append(gb.device_ms(
                    torch, lambda t=t: t.dense.dense_matmul(x, w, b, *sides, **kw)))
            line = {name: sum(v) / len(v) for name, v in times.items()}
            sweep = {}
            for tl in tiles:
                for ns in range(1, this.build.TMA_MAX_CLUSTER + 1):
                    plan = ranges(k, ns)
                    if plan is None:
                        continue
                    pins = dict(block_m=tl[0], block_n=tl[1], block_k=tl[2])
                    with patched(this.build, tma_plan=lambda *_, p=plan: p):
                        sweep[f"t{tl[1]}x{tl[2]}:ns{ns}"] = gb.device_ms(
                            torch, lambda: this.dense.dense_matmul(x, w, b, *sides, **kw, **pins))

            def library():
                y = torch.addmm(b, x, w) if b is not None else torch.matmul(x, w)
                return y + sides[0] if add else y

            lib = gb.device_ms(torch, library)
            nb = sum(t_.numel() * 2 for t_ in (x, w, b, *sides, want) if t_ is not None)
            bound = nb / _PEAK_BYTES_PER_S * 1e3
            ok = max(errs) <= tol
            if not ok:
                failed.append(f"decode {arch} {role}")
            best = min(sweep, key=sweep.get) if sweep else "-"
            label = f"{arch.split('-')[0]} {role} M=3 {k}->{n}" + (" +add" if add else "")
            print(f"  {label:34s} " + " ".join(f"{k_}={v:.4f}({bodies[k_]})"
                                               for k_, v in line.items())
                  + f" addmm={lib:.4f} bound={bound:.4f} best={best}:"
                  + (f"{sweep[best]:.4f}" if sweep else "-") + " "
                  + " ".join(f"{k_}={v:.4f}" for k_, v in sweep.items())
                  + f" err={max(errs):.2e} (tol {tol:.1e}) {'ok' if ok else 'FAIL'}", flush=True)
            rows[role] = (line, lib)
        per_call[arch] = (c.n_layers, rows)
    for arch, (layers, rows) in per_call.items():
        def total(key):
            return layers * sum(mult * (rows[r][0][key] if key else rows[r][1])
                                for r, mult in (("q", 1), ("kv", 2), ("o", 1), ("down", 1)))
        print(f"  {arch} per decode plan call ({layers} layers, {5 * layers} dense launches): "
              + " ".join(f"{k}={total(k):.3f}" for k in rows["q"][0])
              + f" addmm={total(None):.3f} ms")


def bsr_bench(torch, trees, order, randn, failed) -> None:
    """The --bsr mode (module doc)."""
    this = trees["this"]
    w_q, w_o = randn(2048, 2048, scale=2048 ** -0.5), randn(2048, 2048, scale=2048 ** -0.5)
    b_q = randn(2048, scale=0.1)
    per_call = {}
    for label, m, wt, bias, add in (
            ("q decode M=3", 3, w_q, b_q, False), ("q prefill M=48", 48, w_q, b_q, False),
            ("o decode M=3", 3, w_o, None, True), ("o prefill M=48", 48, w_o, None, True)):
        x = randn(m, 2048)
        side = randn(m, 2048) if add else None
        packed = {}
        for name, t in trees.items():
            with gb.active(t):
                mask = t.project(wt, t.Block(0.5, bm=64, bn=64))[1]
                pk = t.PBCSR.from_dense(wt, mask, 64, 64)
            packed[name] = (pk.values, pk.block_rows, pk.to_dense())
        values, rows, dense = packed["this"]
        kw = dict(epilogue=(("add", 0),) if add else ())
        sides = (side,) if add else ()

        def call(t, name):
            v, r, _ = packed[name]
            return t.bsr.bsr_matmul(x, v, r, bias, *sides, **kw)

        want = this.bsr.bsr_matmul_plain(x, values, rows, bias, *sides, **kw).float()
        tol = this.ulp(want.abs().max().item())
        errs, routes = [], {}
        for name, t in trees.items():
            errs.append((call(t, name).float() - want).abs().max().item())
            v, _, _ = packed[name]
            p = t.bsr.plan_for(x, v, 32, 16)
            routes[name] = f"{p.route}/{p.nsplit}"
        times = {}
        for name in order:
            t = trees[name]
            times.setdefault(name, []).append(gb.device_ms(torch, lambda t=t, n=name: call(t, n)))
        line = {name: sum(v) / len(v) for name, v in times.items()}
        sweep = {}
        if hasattr(this.bsr, "TMA_TARGET"):
            for target in (264, 132, 32):
                with patched(this.bsr, TMA_TARGET=target):
                    p = this.bsr.plan_for(x, values, 32, 16)
                    sweep[f"{p.route}:target{target}/{p.nsplit}"] = gb.device_ms(
                        torch, lambda: call(this, "this"))
            if m <= 8:  # the streaming route: the wgmma route made to refuse the blocks
                with patched(this.bsr, tma_bk=lambda bm: 0):
                    p = this.bsr.plan_for(x, values, 32, 16)
                    sweep[f"{p.route}/{p.nsplit}"] = gb.device_ms(torch, lambda: call(this, "this"))

        def library():
            y = torch.addmm(bias, x, dense) if bias is not None else torch.matmul(x, dense)
            return y + side if add else y

        lib = gb.device_ms(torch, library)
        real = int((rows >= 0).sum())
        nb = real * 64 * 64 * 2 + rows.numel() * 4 + sum(
            t_.numel() * 2 for t_ in (x, bias, side, want) if t_ is not None)
        bound = nb / _PEAK_BYTES_PER_S * 1e3
        ok = max(errs) <= tol
        if not ok:
            failed.append(f"bsr {label}")
        print(f"  bsr {label:16s} " + " ".join(f"{k}={v:.4f}({routes[k]})" for k, v in line.items())
              + f" addmm={lib:.4f} bound={bound:.4f} "
              + " ".join(f"{k}={v:.4f}" for k, v in sweep.items())
              + f" err={max(errs):.2e} (tol {tol:.1e}) {'ok' if ok else 'FAIL'}", flush=True)
        per_call[label] = (line, lib)
    for phase in ("prefill", "decode"):
        rows = [v for k, v in per_call.items() if phase in k]
        print(f"  block-pruned qwen2.5-3b per {phase} plan call (36 q + 36 o bsr_matmul): "
              + " ".join(f"{k}={36 * sum(r[0][k] for r in rows):.3f}" for k in rows[0][0])
              + f" addmm={36 * sum(r[1] for r in rows):.3f} ms")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--gemm-only", action="store_true")
    ap.add_argument("--floor", action="store_true")
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--bsr", action="store_true")
    args = ap.parse_args()
    if not (args.floor or args.decode or args.bsr):
        ap.error("name at least one of --floor, --decode, --bsr")
    import torch

    if not torch.cuda.is_available():
        print("wgmma_bench: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    this_src = str(ROOT / "src")
    other = None if Path(args.src).resolve() == Path(this_src).resolve() else args.src
    trees = {}
    if other:
        trees["parent"] = load(other, args.bsr)
    trees["this"] = load(this_src, args.bsr)
    gb.build_trees(list(trees.values()), args.gemm_only,
                   gb._GEMM_SOURCES + (("bsr_matmul.cu",) if args.bsr else ()))
    print(f"== wgmma body on {smi}: " + ", ".join(f"{k} = {t.src}" for k, t in trees.items()),
          flush=True)
    order = ["parent", "this", "this", "parent"] if other else ["this", "this"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    failed = []
    if args.floor:
        print("== floor", flush=True)
        floor_bench(torch, trees, order, randn)
    if args.decode:
        print("== decode (M = 3)", flush=True)
        decode_bench(torch, trees, order, randn, failed)
    if args.bsr:
        print("== bsr_matmul", flush=True)
        bsr_bench(torch, trees, order, randn, failed)
    for name, t in trees.items():
        print(f"  registers ({name}):")
        gb.registers(t.log, gb._WATCHED_BF16 + ("bsr_matmul",))
    if failed:
        print(f"wgmma_bench: {len(failed)} checks failed: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
