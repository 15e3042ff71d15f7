#!/usr/bin/env python3
"""Check and time the GEMM kernels of one or two source trees on the card.

    python3 tools/gemm_bench.py [--src DIR] [--label NAME] [--gemm-only] [--sweep]
    python3 tools/gemm_bench.py --bf16 [--src OTHER_SRC] [--gemm-only | --plans]
    python3 tools/gemm_bench.py --bf16 --ffn [--src OTHER_SRC] [--gemm-only] [--sweep]

``--bf16`` times the bf16 prefill GEMMs (``dense_matmul`` and
``dense_matmul_pipelined``, M = 48) of the three served decoders --
qwen2.5-3b, granite-3-2b, phi4-mini-3.8b: q, k/v, o, down, their widths
from ``configs`` -- each also through the pipelined entry at depth 2 and
3, the odd case M=20 K=71 N=51 and a shape whose K ends inside a BK =
128 slab, for this tree and, with ``--src``, another checkout's
``src`` (its parent, say) in the same process (each tree's package loaded
in turn, its kernels built into its own ``build/``; calls timed parent,
this, this, parent; both trees' kernels are built at once).  Per case:
the body each tree's launch took (``route_launches``; ``-`` where the
tree has none), device ms by torch.profiler (20 calls after 3), host us
of one call (``host_us``: the wrapper and the launch, the median of 200
calls that do not wait on the card), this tree's wgmma body under other
K splits than ``_build.tma_plan``'s (``nsS``: S K ranges, where K holds S
ranges of 128 rows), ``d2`` / ``d3``: the pipelined entry's rings,
``torch.addmm``'s ms (+ the side for ``+add``), the byte bound at 3.35
TB/s, the largest error against the plain version (one bf16 ulp of the
largest plain value) and whether every tile and depth is ``torch.equal``
to the default (else which differ, in how many outputs); then each
decoder's dense ms per prefill plan call (layers x (q + 2 k/v + o +
down)), the registers and spills of every bf16 GEMM instance and ptxas's
wgmma warnings from ``build.log``.  ``--bf16 --plans`` (full builds, not
``--gemm-only``) instead builds each decoder at full width for each tree
(random weights, seed 0) and reports ``profile_plan``'s host and device ms
of one prefill plan call (3 prompts padded to 16 tokens: the M = 48
GEMMs above; 3 traced runs after a warm-up) and the bodies its dense
launches took, the trees timed parent, this, this, parent; then the same
for qwen2.5-3b block-pruned (q / o on ``Block(0.5, 64, 64)``, packed by the
compiler as ``chip_smoke.py``'s block-pruned phase packs them), with its
``bsr_matmul`` launches.

``--bf16 --ffn`` times the bf16 ``ffn_gateup`` instead: the three served
decoders' gate/up (``d_model -> d_ff``, silu) at decode (M = 3) and
prefill (M = 48), qwen3-14b's 5120 -> 17408 at both, and the ragged
M=20 K=130 F=77 (odd K and F: the ``mma_gemm`` body), each tree in the
same process (parent, this, this, parent).  Per case: each tree's body
(``route_launches``), device ms (torch.profiler, 20 calls after 3), host
us of one call, the library's ms (two ``torch.matmul``, the activation,
the product), the byte bound at 3.35 TB/s, the largest error against the
plain version (tolerance one bf16 ulp of max|plain|) and whether every
tile of ``FFN_WGMMA_TILES`` is ``torch.equal`` to the plan's; with
``--sweep`` also this tree's two-weight body on every tile under every
K split ``tTILE:nsS`` (S ranges of whole 128-row steps).  Then each decoder's ``ffn_gateup`` ms per plan call
(layers x one launch) by tree, the registers and spills of every bf16
gate/up instance (``GateUpEpilogue``) from ``build.log``, ptxas's wgmma
warnings, and whether the dense bf16 GEMMs (one weight) at the 12 served
prefill shapes give outputs ``torch.equal`` to the other tree's.

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
import hashlib
import re
import statistics
import subprocess
import sys
import time
import types
import contextlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_GEMM_SOURCES = ("dense_matmul.cu", "dense_matmul_pipelined.cu", "quant_matmul.cu",
                 "quant_matmul_pipelined.cu")
_WATCHED = ("simt_gemm_kernel", "int8_gemm_kernel", "dense_matmul_kernel",
            "quant_matmul_kernel", "pipelined_gemm_kernel")
_WATCHED_BF16 = ("mma_gemm_kernel", "wgmma_gemm_kernel")
#: the served decoders whose prefill GEMMs --bf16 times
_DECODERS = ("qwen2.5-3b", "granite-3-2b", "phi4-mini-3.8b")
_PEAK_BYTES_PER_S = 3.35e12


def gemm_only_library(_build, sources=_GEMM_SOURCES):
    """Build the GEMM sources (``sources``) alone and bind their entry
    points as the package's library (the other entry points stay
    unbound)."""
    names = hashlib.sha256(",".join(sources).encode()).hexdigest()[:8]
    out = _build.REPO_ROOT / "build" / "gemm_only" / (_build.source_hash() + names)
    lib_path = out / "libgemm.so"
    if not lib_path.exists():
        out.mkdir(parents=True, exist_ok=True)
        procs = [subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-c",
             str(_build.CSRC / src), "-o", str(out / (src + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for src in sources]
        logs = [p.communicate()[0] for p in procs]
        (out / "build.log").write_text("\n".join(logs))
        if any(p.returncode for p in procs):
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        subprocess.run([_build._nvcc(), *_build.GENCODE, "-shared", "-o", str(lib_path),
                        *[str(out / (src + ".o")) for src in sources]], check=True)
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


def registers(log_path: Path, watched=_WATCHED) -> None:
    entry = None
    for line in log_path.read_text().splitlines():
        if "wgmma" in line and ("warning" in line or "Performance" in line):
            print(f"  ptxas: {line.strip()[:200]}")
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if any(k in m.group(1) for k in watched) else None
        regs = re.search(r"Used (\d+) registers", line)
        if entry and (regs or ("spill" in line and " 0 bytes spill" not in line)):
            print(f"  ptxas {entry[:90]}: {line.split('ptxas info    :')[-1].strip()}")


def _tree_modules() -> dict:
    return {n: m for n, m in sys.modules.items()
            if n == "repro_torch" or n.startswith("repro_torch.")}


def load_tree(src: str):
    """Import ``src``'s ``repro_torch`` afresh (dropping any ``repro_torch``
    already imported, whose modules keep working through their own
    references)."""
    for name in _tree_modules():
        del sys.modules[name]
    sys.path.insert(0, src)
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import _build
        from repro_torch.kernels import dense_matmul as kdense
        from repro_torch.kernels import dense_matmul_pipelined as kdense_pipe
        from repro_torch.kernels import fused_ffn as kffn
        from repro_torch.kernels.ref import bf16_ulp
        from repro_torch.launch import serve
        from repro_torch.obs import profile_plan
    finally:
        sys.path.remove(src)
    return types.SimpleNamespace(src=src, build=_build, dense=kdense, pipe=kdense_pipe,
                                 ffn=kffn, get_config=get_config, ulp=bf16_ulp, serve=serve,
                                 profile_plan=profile_plan, modules=_tree_modules())


@contextlib.contextmanager
def active(t):
    """``t``'s modules in ``sys.modules`` while the block runs, so that the
    imports its code makes at call time (the plans' executor, tracing)
    reach its own tree; modules first imported meanwhile stay ``t``'s."""
    for name in _tree_modules():
        del sys.modules[name]
    sys.modules.update(t.modules)
    try:
        yield
    finally:
        t.modules = _tree_modules()


def build_trees(trees, gemm_only: bool, sources=_GEMM_SOURCES) -> None:
    """Build every tree's kernels at once (a thread each, so that their nvcc
    processes run side by side), then bind each library."""
    def make(t):
        return gemm_only_library(t.build, sources) if gemm_only else t.build.build()

    with ThreadPoolExecutor(len(trees)) as pool:
        paths = list(pool.map(make, trees))
    for t, path in zip(trees, paths):
        if not gemm_only:
            t.build.lib()
        t.log = path.parent / "build.log"


def host_us(torch, fn, reps=200):
    """Host us of one call: the median of ``reps`` calls timed on the host
    clock, after 3 warm-up calls; nothing waits on the card in between
    (its queue stays short: each call's kernel takes tens of us)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def device_ms(torch, fn, reps=20):
    """Device ms of one call: the time of every kernel ``reps`` calls launch
    (torch.profiler, after 3 warm-up calls; host gaps not counted)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # a session now and then sees no device event: try again
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / reps / 1e3
    return float("nan")


def bf16_bench(args, torch) -> int:
    """The --bf16 mode (module doc)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    this_src = str(ROOT / "src")
    other = None if Path(args.src).resolve() == Path(this_src).resolve() else args.src
    trees = {}
    if other:
        trees["parent"] = load_tree(other)
    trees["this"] = this = load_tree(this_src)
    build_trees(list(trees.values()), args.gemm_only,
                _GEMM_SOURCES + ("fused_ffn.cu",) if args.ffn else _GEMM_SOURCES)
    if args.ffn:
        return ffn_bench(args, torch, smi, trees)
    print(f"== bf16 prefill GEMMs on {smi}: "
          + ", ".join(f"{k} = {t.src}" for k, t in trees.items()))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    failed = []
    order = ["parent", "this", "this", "parent"] if other else ["this", "this"]

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf16)

    def routes(t):
        """Launches by body: ``d:`` the tiled entry's, ``p:`` the pipelined one's."""
        return {**{f"d:{k}": v for k, v in getattr(t.dense, "route_launches", {}).items()},
                **{f"p:{k}": v for k, v in getattr(t.pipe, "route_launches", {}).items()}}

    def took(t, before):
        after = routes(t)
        return ",".join(k for k in after if after[k] != before.get(k, 0)) or "-"

    def with_ranges(ns):
        """A plan of ``ns`` K ranges, cut to whole 128-row steps."""
        def plan(m, n, k):
            kc = -(-(-(-k // ns)) // 128) * 128
            return kc, -(-k // kc)
        return plan

    def under(plan, fn):
        """``fn()`` with this tree's wgmma launches planned by ``plan``."""
        real = this.build.tma_plan
        this.build.tma_plan = plan
        try:
            return fn()
        finally:
            this.build.tma_plan = real

    per_call = {}

    def case(label, m, k, n, bias, add, depths=()):
        x, w = randn(m, k), randn(k, n, scale=k ** -0.5)
        b = randn(n, scale=0.1) if bias else None
        sides = (randn(m, n),) if add else ()
        kw = dict(epilogue=(("add", 0),) if add else ())
        want = this.dense.dense_matmul_plain(x, w, b, *sides, **kw).float()
        tol = this.ulp(want.abs().max().item())
        times, bodies, errs = {}, {}, []
        for name, t in trees.items():
            before = routes(t)
            out = t.dense.dense_matmul(x, w, b, *sides, **kw)
            torch.cuda.synchronize()
            bodies[name] = took(t, before)
            errs.append((out.float() - want).abs().max().item())
            if name == "this":
                ref = out
        differ = []
        for t_ in this.build.BF16_GEMM_TILES:
            got = (this.dense.dense_matmul(x, w, b, *sides, **kw, block_m=t_[0], block_n=t_[1],
                                           block_k=t_[2])
                   if t_[3] == 1 else this.pipe.dense_matmul_pipelined(
                       x, w, b, *sides, **kw, block_m=t_[0], block_n=t_[1], block_k=t_[2],
                       depth=t_[3]))
            if not torch.equal(got, ref):
                differ.append(f"{'x'.join(map(str, t_))}:{int((got != ref).sum())}")
        eq = not differ
        again = this.dense.dense_matmul(x, w, b, *sides, **kw)
        if not torch.equal(again, ref):
            differ.append(f"default-again:{int((again != ref).sum())}")
        for name in order:
            t = trees[name]
            ms = device_ms(torch, lambda t=t: t.dense.dense_matmul(x, w, b, *sides, **kw))
            times.setdefault(name, []).append(ms)
        line = {name: sum(v) / len(v) for name, v in times.items()}
        host = {}
        for name in order:
            t = trees[name]
            host.setdefault(name, []).append(
                host_us(torch, lambda t=t: t.dense.dense_matmul(x, w, b, *sides, **kw)))
        extra = {f"host_us {name}": sum(v) / len(v) for name, v in host.items()}
        if bodies["this"].endswith("wgmma"):
            for ns in range(1, this.build.TMA_MAX_CLUSTER + 1):
                plan = with_ranges(ns)
                if plan(m, n, k) != this.build.tma_plan(m, n, k) and plan(m, n, k)[1] == ns:
                    extra[f"ns{ns}"] = under(plan, lambda: device_ms(
                        torch, lambda: this.dense.dense_matmul(x, w, b, *sides, **kw)))
        for d in depths:
            before = routes(this)
            this.pipe.dense_matmul_pipelined(x, w, b, *sides, **kw, depth=d)
            extra[f"d{d}"] = device_ms(
                torch, lambda d=d: this.pipe.dense_matmul_pipelined(x, w, b, *sides, **kw, depth=d))
            extra[f"d{d} body"] = took(this, before)
            if other and d == depths[0]:
                for dd in depths:
                    extra[f"parent d{dd}"] = device_ms(torch, lambda dd=dd: trees[
                        "parent"].pipe.dense_matmul_pipelined(x, w, b, *sides, **kw, depth=dd))

        def library():
            y = torch.addmm(b, x, w) if bias else torch.matmul(x, w)
            return y + sides[0] if add else y

        lib = device_ms(torch, library)
        nb = sum(t_.numel() * 2 for t_ in (x, w, b, *sides, want) if t_ is not None)
        bound = nb / _PEAK_BYTES_PER_S * 1e3
        ok = max(errs) <= tol and eq
        if not ok:
            failed.append(label)
        print(f"  {label:38s} " + " ".join(f"{k}={v:.4f}({bodies[k]})" for k, v in line.items())
              + " " + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                               for k, v in extra.items())
              + f" addmm={lib:.4f} bound={bound:.4f} err={max(errs):.2e} (tol {tol:.1e}) "
              f"tiles/depths {'equal' if eq else 'DIFFER ' + ' '.join(differ)} "
              f"{'ok' if ok else 'FAIL'}")
        return line, lib

    if args.plans:
        plan_calls(torch, trees, order, routes)
        return 0
    for arch in _DECODERS:
        c = this.get_config(arch)
        d, dh, h, g, f = c.d_model, c.resolved_head_dim, c.n_heads, c.n_kv_heads, c.d_ff
        rows = {}
        for role, k, n, add in (("q", d, h * dh, False), ("kv", d, g * dh, False),
                                ("o", h * dh, d, True), ("down", f, d, True)):
            rows[role] = case(f"{arch.split('-')[0]} {role} M=48 {k}->{n}" + (" +add" if add
                                                                              else ""),
                              48, k, n, c.qkv_bias and not add, add, depths=(2, 3))
        per_call[arch] = (c.n_layers, rows)
    case("M=20 K=71 N=51 +add (odd K, N)", 20, 71, 51, True, True, depths=(2, 3))
    # K ends inside a BK = 128 slab (TMA's zero fill past K)
    case("M=48 K=2112 N=256 (K ends in a slab)", 48, 2112, 256, True, False)
    for arch, (layers, rows) in per_call.items():
        def total(key):
            return layers * sum(mult * (rows[r][0][key] if key else rows[r][1])
                                for r, mult in (("q", 1), ("kv", 2), ("o", 1), ("down", 1)))
        print(f"  {arch} per prefill plan call ({layers} layers, {5 * layers} dense launches): "
              + " ".join(f"{k}={total(k):.3f}" for k in rows["q"][0])
              + f" addmm={total(None):.3f} ms")
    for name, t in trees.items():
        print(f"  registers ({name}):")
        registers(t.log, _WATCHED_BF16)
    if failed:
        print(f"gemm_bench: {len(failed)} checks failed: {failed}")
        return 1
    return 0


def ffn_bench(args, torch, smi, trees) -> int:
    """The --bf16 --ffn mode (module doc)."""
    import torch.nn.functional as F

    this, other = trees["this"], "parent" in trees
    print(f"== bf16 ffn_gateup on {smi}: "
          + ", ".join(f"{k} = {t.src}" for k, t in trees.items()))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    failed = []
    order = ["parent", "this", "this", "parent"] if other else ["this", "this"]

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf16)

    def took(t, before):
        after = getattr(t.ffn, "route_launches", {})
        return ",".join(k for k in after if after[k] != before.get(k, 0)) or "-"

    @contextlib.contextmanager
    def patched(**fns):
        """This tree's ``_build`` functions replaced while the block runs."""
        real = {name: getattr(this.build, name) for name in fns}
        for name, fn in fns.items():
            setattr(this.build, name, fn)
        try:
            yield
        finally:
            for name, fn in real.items():
                setattr(this.build, name, fn)

    def case(label, m, k, f):
        x = randn(m, k)
        wg, wu = randn(k, f, scale=k ** -0.5), randn(k, f, scale=k ** -0.5)
        want = this.ffn.ffn_gateup_plain(x, wg, wu).float()
        tol = this.ulp(want.abs().max().item())
        bodies, errs, outs = {}, [], {}
        for name, t in trees.items():
            before = dict(getattr(t.ffn, "route_launches", {}))
            outs[name] = t.ffn.ffn_gateup(x, wg, wu)
            torch.cuda.synchronize()
            bodies[name] = took(t, before)
            errs.append((outs[name].float() - want).abs().max().item())
        ref = outs["this"]
        extra, differ = {}, []
        if bodies["this"] == "wgmma":
            _, kchunk, nsplit = this.build.ffn_tma_plan(m, f, k)
            extra["plan"] = f"{'x'.join(map(str, this.build.ffn_tma_plan(m, f, k)[0]))}:ns{nsplit}"
            for tile in this.build.FFN_WGMMA_TILES:
                with patched(ffn_tma_plan=lambda *_, tile=tile: (tile, kchunk, nsplit)):
                    got = this.ffn.ffn_gateup(x, wg, wu)
                if not torch.equal(got, ref):
                    differ.append(f"{'x'.join(map(str, tile))}:{int((got != ref).sum())}")
        again = this.ffn.ffn_gateup(x, wg, wu)
        if not torch.equal(again, ref):
            differ.append(f"default-again:{int((again != ref).sum())}")
        times, host = {}, {}
        for name in order:
            t = trees[name]
            fn = lambda t=t: t.ffn.ffn_gateup(x, wg, wu)  # noqa: E731
            times.setdefault(name, []).append(device_ms(torch, fn))
            host.setdefault(name, []).append(host_us(torch, fn))
        line = {name: sum(v) / len(v) for name, v in times.items()}
        extra.update({f"host_us {name}": sum(v) / len(v) for name, v in host.items()})
        if args.sweep and bodies["this"] == "wgmma":
            for tile in this.build.FFN_WGMMA_TILES:
                for ns in range(1, this.build.TMA_MAX_CLUSTER + 1):
                    kc = -(-(-(-k // ns)) // 128) * 128
                    if -(-k // kc) != ns:
                        continue
                    with patched(ffn_tma_plan=lambda *_, tile=tile, kc=kc, ns=ns: (tile, kc, ns)):
                        extra[f"t{'x'.join(map(str, tile))}:ns{ns}"] = device_ms(
                            torch, lambda: this.ffn.ffn_gateup(x, wg, wu))

        def library():
            return F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu)

        lib = device_ms(torch, library)
        bound = sum(t_.numel() * 2 for t_ in (x, wg, wu, ref)) / _PEAK_BYTES_PER_S * 1e3
        ok = max(errs) <= tol and not differ
        if not ok:
            failed.append(label)
        print(f"  {label:30s} " + " ".join(f"{k}={v:.4f}({bodies[k]})" for k, v in line.items())
              + f" library={lib:.4f} bound={bound:.4f} "
              + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                         for k, v in extra.items())
              + f" err={max(errs):.2e} (tol {tol:.1e}) tiles "
              f"{'equal' if not differ else 'DIFFER ' + ' '.join(differ)} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        return line, lib

    per_call = {}
    for arch in _DECODERS + ("qwen3-14b",):
        c = this.get_config(arch)
        for phase, m in (("decode", 3), ("prefill", 48)):
            per_call[(arch, phase)] = (c.n_layers, case(
                f"{arch.split('-')[0]} {phase} M={m} {c.d_model}->{c.d_ff}", m, c.d_model,
                c.d_ff))
    case("M=20 K=130 F=77 (odd K, F)", 20, 130, 77)
    for (arch, phase), (layers, (line, lib)) in per_call.items():
        print(f"  {arch} ffn_gateup per {phase} plan call ({layers} launches): "
              + " ".join(f"{k}={layers * v:.3f}" for k, v in line.items())
              + f" library={layers * lib:.3f} ms")
    if other:  # the dense bf16 GEMMs (one weight): the same bits as the other tree's
        differ = []
        for arch in _DECODERS:
            c = this.get_config(arch)
            d, dh, h, g, f = c.d_model, c.resolved_head_dim, c.n_heads, c.n_kv_heads, c.d_ff
            for role, k, n, add in (("q", d, h * dh, False), ("kv", d, g * dh, False),
                                    ("o", h * dh, d, True), ("down", f, d, True)):
                x, w = randn(48, k), randn(k, n, scale=k ** -0.5)
                b = randn(n, scale=0.1) if c.qkv_bias and not add else None
                sides = (randn(48, n),) if add else ()
                kw = dict(epilogue=(("add", 0),) if add else ())
                outs = [t.dense.dense_matmul(x, w, b, *sides, **kw) for t in trees.values()]
                if not torch.equal(*outs):
                    differ.append(f"{arch} {role}")
        print(f"  dense bf16 at the 12 served prefill shapes: "
              + ("torch.equal to the parent's" if not differ else f"DIFFER {differ}"))
        if differ:
            failed.append("dense bf16 equality")
    for name, t in trees.items():
        print(f"  gate/up registers ({name}):")
        registers(t.log, ("GateUpEpilogue",))
    if failed:
        print(f"gemm_bench: {len(failed)} checks failed: {failed}")
        return 1
    return 0


def plan_calls(torch, trees, order, routes) -> None:
    """The ``--plans`` part (module doc): per decoder, each tree's plans
    built in turn (the previous freed first), timed in ``order``; the
    dense launches of one untimed call by body.  qwen2.5-3b also
    block-pruned: q / o projected onto ``Block(0.5, 64, 64)`` and packed as
    PBCSR by the compiler (``chip_smoke.block_pruned_llm``), its
    ``bsr_matmul`` launches counted beside the dense ones."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    dev = torch.device("cuda")
    for arch in _DECODERS + ("qwen2.5-3b block-pruned",):
        res, bodies = {}, {}
        for name in order:
            t = trees[name]
            args = argparse.Namespace(arch=arch.split()[0], smoke=False, seed=0, guarded=False,
                                      frames=3, prompt_len=16)
            with active(t), torch.no_grad():
                llm = t.serve.build_llm(args, dev)
                if arch.endswith("block-pruned"):
                    from repro_torch.core.pruning import Block
                    from repro_torch.kernels import bsr_matmul as kbsr

                    llm = cs.block_pruned_llm(torch, llm, Block(0.5, bm=64, bn=64))
                    bsr0 = kbsr.launches
                prompts = t.serve.llm_prompts(args, llm["cfg"])
                nb, s = len(prompts), 16
                tokens = torch.zeros(nb, s, dtype=torch.int32)
                for i, p in enumerate(prompts):
                    tokens[i, :len(p)] = torch.from_numpy(p)
                lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
                positions = torch.arange(s, dtype=torch.int32).expand(nb, s).contiguous()
                inputs = [a.to(dev) for a in (tokens, positions, lengths)]
                plan = llm["plans"]["prefill"]
                before = routes(t)
                plan(plan.graph.params, *inputs)
                torch.cuda.synchronize()
                after = routes(t)
                bodies[name] = ",".join(f"{k}={after[k] - before.get(k, 0)}" for k in after
                                        if after[k] != before.get(k, 0)) or "-"
                if arch.endswith("block-pruned"):
                    bodies[name] += f"; bsr_matmul={kbsr.launches - bsr0}"
                pp = t.profile_plan(plan, plan.graph.params, *inputs, runs=3, warmup=1)
                res.setdefault(name, []).append((pp.total_ms, pp.total_device_ms))
                del llm, plan, inputs
            torch.cuda.empty_cache()
        print(f"  {arch} prefill plan call ({len(order)} sessions: {', '.join(order)}): "
              + "; ".join(f"{name} host " + "/".join(f"{h:.3f}" for h, _ in v) + " ms, device "
                          + "/".join(f"{d:.3f}" for _, d in v) + f" ms (dense: {bodies[name]})"
                          for name, v in res.items()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--gemm-only", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--ffn", action="store_true")
    args = ap.parse_args()
    if args.ffn and (args.plans or not args.bf16):
        ap.error("--ffn needs --bf16 (and no --plans)")
    if args.plans and (args.gemm_only or not args.bf16):
        ap.error("--plans needs --bf16 and the full build (no --gemm-only)")
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("gemm_bench: no CUDA device", file=sys.stderr)
        return 2
    if args.bf16:
        return bf16_bench(args, torch)
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
