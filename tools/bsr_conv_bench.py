#!/usr/bin/env python3
"""Time and check the block-sparse, conv and flash-attention kernels of one
source tree on the card, without stopping at a disagreement.

    python3 tools/bsr_conv_bench.py [--src DIR] [--label NAME] [--tiles]
                                    [--only bsr|conv|w8a8|flash|ffn]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (by
default this repository's; give another checkout's to time it in the same
process run -- its kernels build into its own ``build/``).  Prints the
card's name and power limit, each kernel's registers and spills from the
build log, then one line per case: max error against the plain version
and its tolerance (one bf16 ulp of the largest value for bf16 outputs,
1e-4 x max(1, max|plain|) for f32, 1e-5 for W8A8), the kernel's device
ms (torch.profiler, 20 calls), the library call's (``torch.addmm`` on the
dense weight, ``F.conv2d`` with TF32 off) and, on trees that have it, the
``bsr_matmul`` route and split.  ``--tiles`` adds every conv tile on the
7x7, 3x3 96-of-192->32, W8 3x3 s2 and W8A8 cases; ``--only`` runs one
kernel's cases (``w8a8``: the conv kernel's W8A8 cases alone; ``flash``:
flash attention at qwen2.5-3b's shapes, with its route on trees that have
one and ``F.scaled_dot_product_attention`` as the library call; ``ffn``:
the gate/up FFN in f32 at the smoke decoder's and qwen2.5-3b's widths, a
ragged case a route, and the bf16 gate/up and dense q / down at
qwen2.5-3b's widths as controls -- with the byte / FMA bound, the kernels
one call launches, and the smoke decoder's ms a plan call);
``--tma-target`` / ``--stream-target`` set the block-sparse routes' split
targets for the run (a sweep of the split), ``--flash-target``
/ ``--flash-chunk`` the flash split route's CTAs and most keys a split,
``--ffn-target`` / ``--ffn-min-k`` the f32 gate/up GEMM's split target and
fewest K rows a range.  A case over its tolerance is marked ``FAIL`` and
the script exits 1 after the last case.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: kernels whose registers and spills the build log's lines are printed for
_WATCHED = ("bsr_matmul", "conv2d_igemm", "flash_attention", "ffn_gateup", "skinny_gemm")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--only", choices=("bsr", "conv", "w8a8", "flash", "ffn"),
                    help="one kernel's cases only")
    ap.add_argument("--tma-target", type=int, help="bsr_matmul.TMA_TARGET for this run")
    ap.add_argument("--stream-target", type=int, help="bsr_matmul.STREAM_TARGET for this run")
    ap.add_argument("--flash-target", type=int,
                    help="flash_attention.SPLIT_TARGET for this run (the split route's CTAs)")
    ap.add_argument("--flash-chunk", type=int,
                    help="flash_attention.SPLIT_MAX_CHUNK for this run (most keys a split)")
    ap.add_argument("--ffn-target", type=int,
                    help="_build.FFN_SPLIT_TARGET for this run (the f32 gate/up GEMM's blocks)")
    ap.add_argument("--ffn-min-k", type=int,
                    help="_build.FFN_SPLIT_MIN_K for this run (fewest K rows a range)")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bsr_conv_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, args.src)
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core.pruning import Block, project
    from repro_torch.core.sparse import PBCSR
    from repro_torch.kernels import _build
    from repro_torch.kernels import bsr_matmul as kbsr
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels.ref import _ACT, bf16_ulp, xla_conv_pads
    from repro_torch.quant import QTensor, quantize_array

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"== {args.label}: {smi}")
    lib = _build.build()
    _build.lib()
    fn = None
    for line in (lib.parent / "build.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif fn and any(k in fn for k in _WATCHED) and "Used" in line:
            print(f"  ptxas {fn[:90]}: {line.split(':', 1)[1].strip()}")
        elif fn and any(k in fn for k in _WATCHED) and "spill" in line \
                and " 0 bytes spill stores" not in line:
            print(f"  ptxas {fn[:90]}: {line.strip()}")

    if args.tma_target:
        kbsr.TMA_TARGET = args.tma_target
    if args.stream_target:
        kbsr.STREAM_TARGET = args.stream_target
    if args.flash_target:
        from repro_torch.kernels import flash_attention as kflash

        kflash.SPLIT_TARGET = args.flash_target
    if args.flash_chunk:
        from repro_torch.kernels import flash_attention as kflash

        kflash.SPLIT_MAX_CHUNK = args.flash_chunk
    if args.ffn_target:
        _build.FFN_SPLIT_TARGET = args.ffn_target
    if args.ffn_min_k:
        _build.FFN_SPLIT_MIN_K = args.ffn_min_k
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    bf16 = torch.bfloat16
    failed = []

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def report(kind, label, out, want, tol, kernel, library, extra=""):
        err = (out.float() - want.float()).abs().max().item()
        ms = cs.device_ms(torch, kernel)
        lib_ms = cs.device_ms(torch, library) if library else float("nan")
        bad = not err <= tol
        if bad:
            failed.append(label)
        print(f"  {kind:5s} {label:48s} err={err:.3e} tol={tol:.1e}{' FAIL' if bad else ''} "
              f"ms={ms:.4f} library_ms={lib_ms:.4f} {extra}")
        return ms

    # -- bsr_matmul ---------------------------------------------------------- #
    def bsr(label, m, k, n, bm, bn, dtype, balanced=True, bias=True, add=False, bands=None,
            act=None):
        w = randn(k, n, scale=k ** -0.5, dtype=dtype)
        mask = project(w, Block(0.5, bm=bm, bn=bn, balanced=balanced))[1]
        f = PBCSR.from_dense(w, mask, bm, bn)
        values, rows = f.values, f.block_rows
        nb, s = rows.shape
        bands = bands or ((0, nb, s),)
        x = randn(m, k, dtype=dtype)
        b = randn(n, scale=0.1, dtype=dtype) if bias else None
        sides = (randn(m, n, dtype=dtype),) if add else ()
        epi = (("add", 0),) if add else ()

        def run(fn):
            out = torch.empty((m, n), dtype=dtype, device=dev)
            for band in bands:
                fn(x, values, rows, b, *sides, activation=act, epilogue=epi, band=band, out=out)
            return out

        out, want = run(kbsr.bsr_matmul), run(kbsr.bsr_matmul_plain)
        top = want.float().abs().max().item()
        tol = bf16_ulp(top) if dtype == bf16 else 1e-4 * max(1.0, top)
        dense = f.to_dense()

        def library():
            y = torch.addmm(b, x, dense) if bias else torch.matmul(x, dense)
            y = _ACT[act](y)
            return y + sides[0] if add else y

        extra = ""
        if hasattr(kbsr, "plan_for"):
            extra = " ".join(f"{kbsr.plan_for(x, values, e - st, c).route}/"
                             f"{kbsr.plan_for(x, values, e - st, c).nsplit}"
                             for st, e, c in bands)
        report("bsr", label, out, want, tol, lambda: run(kbsr.bsr_matmul), library,
               f"pads={int((rows < 0).sum())} {extra}")

    bsr_cases = args.only in (None, "bsr")
    if bsr_cases:
        bsr("q decode M=3 2048->2048 b64 +bias", 3, 2048, 2048, 64, 64, bf16)
        bsr("q prefill M=48 2048->2048 b64 +bias", 48, 2048, 2048, 64, 64, bf16)
        bsr("o decode M=3 2048->2048 b64 +add", 3, 2048, 2048, 64, 64, bf16, bias=False, add=True)
        bsr("o prefill M=48 2048->2048 b64 +add", 48, 2048, 2048, 64, 64, bf16, bias=False,
            add=True)
        bsr("bf16 M=1 512->256 b16x16", 1, 512, 256, 16, 16, bf16)
        bsr("bf16 M=8 256->384 b32x24 unbalanced", 8, 256, 384, 32, 24, bf16, balanced=False,
            add=True)
        bsr("bf16 M=9 256->256 b16x16 gelu", 9, 256, 256, 16, 16, bf16, act="gelu")
        bsr("bf16 M=13 192->96 b16x32 unbalanced +add", 13, 192, 96, 16, 32, bf16, balanced=False,
            add=True)
        bsr("bf16 M=70 512->320 b64x40 unbalanced", 70, 512, 320, 64, 40, bf16, balanced=False)
        bsr("bf16 M=20 256->256 b32x32 2 bands + empty", 20, 256, 256, 32, 32, bf16,
            balanced=False, bands=((0, 1, 0), (1, 5, 2), (5, 8, 4)))
        bsr("bf16 M=5 256->256 b8x8 (cuda core? stream)", 5, 256, 256, 8, 8, bf16)
        bsr("bf16 M=33 256->256 b8x8 (cuda core)", 33, 256, 256, 8, 8, bf16)
        bsr("f32 M=8 256->512 b128 unbalanced +add", 8, 256, 512, 128, 128, torch.float32,
            balanced=False, add=True)
        bsr("f32 M=48 2048->2048 b64", 48, 2048, 2048, 64, 64, torch.float32)

    # -- conv2d -------------------------------------------------------------- #
    def conv(label, n, c_in, hw, o, k, stride, c_live=None, act=None, add=False, scheme="f32",
             tiles=False):
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
        sides = (randn(n, o, oh, ow),) if add else ()
        kw = dict(kept=kept, stride=stride, padding="SAME", activation=act,
                  epilogue=(("add", 0),) if add else ())
        w_lib = wt
        if scheme != "f32":
            qt = QTensor.from_float(wt, axis=0)
            wt, ws = qt.values, qt.scale
            if scheme == "w8a8":
                xs = torch.full((1,), x.abs().max().item() / 127.0, device=dev)
                x, ws = quantize_array(x, xs), ws * xs
            kw["ws"] = ws
            w_lib = wt.float() * ws[:, None, None, None]
        out = kconv.conv2d_gemm(x, wt, b, *sides, **kw)
        want = kconv.conv2d_plain(x, wt, b, *sides, **kw)
        xg = x if kept is None else x.index_select(1, kept)
        ph = xla_conv_pads(h, k, stride, "SAME", 0)
        pw = xla_conv_pads(w_, k, stride, "SAME", 1)
        xp = F.pad(xg.float(), (pw[0], pw[1], ph[0], ph[1]))

        def library():
            y = _ACT[act](F.conv2d(xp, w_lib, b, stride=stride))
            return y + sides[0] if add else y

        tol = (1e-5 if scheme == "w8a8" else 1e-4) * max(1.0, want.abs().max().item())
        tile = _build.conv_default_tile(scheme, o)
        report("conv", f"{scheme} {label}", out, want, tol,
               lambda: kconv.conv2d_gemm(x, wt, b, *sides, **kw), library,
               f"tile={'x'.join(map(str, tile))}")
        if tiles:
            parts = []
            for t in _build.CONV_TILES:
                call = lambda t=t: kconv.conv2d_gemm(  # noqa: E731
                    x, wt, b, *sides, **kw, block_m=t[0], block_n=t[1], block_k=t[2])
                same = torch.equal(call(), out)
                if not same:
                    failed.append(f"{label} tile {t}")
                parts.append(f"{'x'.join(map(str, t))}={cs.device_ms(torch, call, 10):.4f}"
                             f"{'' if same else '(DIFFERS)'}")
            print(f"  conv  every tile, {scheme} {label}: {' '.join(parts)}")

    # -- flash_attention ----------------------------------------------------- #
    def flash(label, b, h, g, sq, skv, d, lengths, causal, q_dtype, kv_dtype):
        from repro_torch.kernels import flash_attention as kflash

        q = randn(b, sq, h, d, dtype=q_dtype).permute(0, 2, 1, 3)
        k = randn(b, skv, g, d, dtype=kv_dtype).permute(0, 2, 1, 3)
        v = randn(b, skv, g, d, dtype=kv_dtype).permute(0, 2, 1, 3)
        lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = kflash.flash_attention(q, k, v, lens, causal=causal)
        want = kflash.flash_attention_plain(q, k, v, lens, causal=causal)
        top = want.float().abs().max().item()
        tol = bf16_ulp(top) if out.dtype == bf16 else 1e-4 * max(1.0, top)
        rep = h // g
        kr, vr, ql = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1), q.to(kv_dtype)
        cols = torch.arange(skv, device=dev)
        mask = torch.ones(b, 1, sq, skv, dtype=torch.bool, device=dev)
        if causal:
            mask &= cols[None, None, None, :] <= torch.arange(sq, device=dev)[None, None, :, None]
        if lens is not None:
            mask &= cols[None, None, None, :] < lens[:, None, None, None]
        extra = ""
        if hasattr(kflash, "plan_for"):
            fp = kflash.plan_for(q, k, v, causal)
            extra = f"route={fp.route} splits={fp.nsplit}x{fp.chunk}"
        report("flash", label, out, want, tol,
               lambda: kflash.flash_attention(q, k, v, lens, causal=causal),
               lambda: F.scaled_dot_product_attention(ql, kr, vr, attn_mask=mask), extra)

    if args.only in (None, "flash"):
        f32 = torch.float32
        flash("decode q bf16 kv f32 B3 H16/G2 span1024 +len", 3, 16, 2, 1, 1024, 128,
              [1000, 517, 64], False, bf16, f32)
        flash("prefill bf16 B3 H16/G2 S16 causal +len", 3, 16, 2, 16, 16, 128, [16, 11, 5],
              True, bf16, bf16)
        flash("bf16 B3 H16/G2 S100 causal, no lengths", 3, 16, 2, 100, 100, 128, None, True,
              bf16, bf16)
        flash("f32 B2 H4/G2 Sq3 Skv37 d32 +len (0 incl.)", 2, 4, 2, 3, 37, 32, [0, 29], False,
              f32, f32)
        flash("prefill bf16 B3 H16/G2 S512 causal +len", 3, 16, 2, 512, 512, 128,
              [512, 300, 77], True, bf16, bf16)
        flash("decode q bf16 kv f32 B3 H16/G2 span4096 +len", 3, 16, 2, 1, 4096, 128,
              [4000, 2100, 64], False, bf16, f32)
        flash("decode q bf16 kv f32 B1 H16/G2 span1024 +len", 1, 16, 2, 1, 1024, 128, [1000],
              False, bf16, f32)
        flash("decode bf16 B2 H16/G2 span512 +len [0, 40]", 2, 16, 2, 1, 512, 128, [0, 40],
              False, bf16, bf16)
        flash("bf16 B2 H8/G8 S40 d64 causal +len [40, 0]", 2, 8, 8, 40, 40, 64, [40, 0], True,
              bf16, bf16)
        flash("f32 B2 H4/G2 S20 d32 causal +len [20, 0]", 2, 4, 2, 20, 20, 32, [20, 0], True,
              f32, f32)
    if args.only == "ffn":
        ffn_cases(torch, cs, dev, randn, report, bf16)
    if args.only in ("bsr", "flash", "ffn"):
        if failed:
            print(f"FAILED: {failed}")
        return 1 if failed else 0
    B, S = 4, 256
    if args.only == "w8a8":
        conv("3x3 s1 64-of-128->128 relu @64^2 n4", B, 128, (64, 64), 128, 3, 1, c_live=64,
             act="relu", scheme="w8a8", tiles=args.tiles)
        conv("3x3 s2 32-of-64->64 relu @128^2 n4", B, 64, (128, 128), 64, 3, 2, c_live=32,
             act="relu", scheme="w8a8")
        conv("3x3 s2 24->40 +add @37x29 n2", 2, 24, (37, 29), 40, 3, 2, add=True, scheme="w8a8")
        conv("3x3 s1 13-of-16->40 +add @37x29 n2 (ragged)", 2, 16, (37, 29), 40, 3, 1,
             c_live=13, add=True, scheme="w8a8", tiles=args.tiles)
        if failed:
            print(f"FAILED: {failed}")
        return 1 if failed else 0
    conv("7x7 s1 3->32 @256^2 n4", B, 3, (S, S), 32, 7, 1, tiles=args.tiles)
    conv("3x3 s2 16-of-32->64 @256^2 n4", B, 32, (S, S), 64, 3, 2, c_live=16)
    conv("3x3 s1 96-of-192->32 +add @256^2 n4", B, 192, (S, S), 32, 3, 1, c_live=96, add=True,
         tiles=args.tiles)
    conv("3x3 s1 96-of-192->32 (no add) @256^2 n4", B, 192, (S, S), 32, 3, 1, c_live=96)
    conv("3x3 s1 8-of-16->2 tanh @256^2 n4", B, 16, (S, S), 2, 3, 1, c_live=8, act="tanh")
    conv("3x3 s2 24->40 relu @37x29 n2", 2, 24, (37, 29), 40, 3, 2, act="relu")
    conv("3x3 s1 96-of-192->32 +add @256^2 n4", B, 192, (S, S), 32, 3, 1, c_live=96, add=True,
         scheme="w8", tiles=args.tiles)
    conv("3x3 s2 16-of-32->64 @256^2 n4", B, 32, (S, S), 64, 3, 2, c_live=16, scheme="w8",
         tiles=args.tiles)
    conv("3x3 s2 24->40 relu @37x29 n2", 2, 24, (37, 29), 40, 3, 2, act="relu", scheme="w8")
    conv("3x3 s1 64-of-128->128 relu @64^2 n4", B, 128, (64, 64), 128, 3, 1, c_live=64,
         act="relu", scheme="w8a8")
    conv("7x7 s1 5->12 kept 3 @61x53 n3 (ragged)", 3, 5, (61, 53), 12, 7, 1, c_live=3)
    if failed:
        print(f"FAILED: {failed}")
        return 1
    return 0


def ffn_cases(torch, cs, dev, randn, report, bf16):
    """The gate/up FFN's f32 routes at the served shapes and qwen2.5-3b's
    widths, their ragged cases, and bf16 controls (the gate/up and the
    dense q / down projections)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import dense_matmul as kdense
    from repro_torch.kernels import fused_ffn as kffn
    from repro_torch.kernels.ref import _ACT, bf16_ulp

    ms = {}

    def ffn(label, m, k, f, dtype, act="silu", offset=0):
        x = randn(m, k, dtype=dtype)
        # offset > 0: weights 4 * offset bytes past a 16-byte boundary
        wg, wu = (randn(k * f + offset, scale=k ** -0.5, dtype=dtype)[offset:].view(k, f)
                  for _ in range(2))
        call = lambda: kffn.ffn_gateup(x, wg, wu, activation=act)  # noqa: E731
        out, want = call(), kffn.ffn_gateup_plain(x, wg, wu, activation=act)
        top = want.float().abs().max().item()
        tol = bf16_ulp(top) if dtype == bf16 else 1e-4 * max(1.0, top)
        kernels = cs.device_kernels(torch, call)
        nb = cs.nbytes(x, wg, wu, out)
        b_ms, b_by = cs.bound(nb, 4.0 * m * k * f,
                              cs.PEAK_BF16_FLOPS if dtype == bf16 else cs.PEAK_F32_FLOPS)
        plan = ""
        if dtype == torch.float32 and hasattr(_build, "ffn_split_f32"):
            if m <= _build.SKINNY_MT and k > 0:
                plan = f"plan={_build.skinny_plan_f32(m, f, k, 4 if f % 4 == 0 else 1)}"
            else:
                plan = f"tile={_build.ffn_tile_f32(m)} plan={_build.ffn_split_f32(m, f, k)}"
        ms[label] = report("ffn", label, out, want, tol, call,
                           lambda: _ACT[act](torch.matmul(x, wg)) * torch.matmul(x, wu),
                           f"bound_ms={b_ms:.4f} ({b_by}) kernels/call={len(kernels)} {plan} "
                           f"[{'; '.join(n.split('(')[0][:60] for n in kernels)}]")

    def dense(label, m, k, n):
        x = randn(m, k, dtype=bf16)
        wt = randn(k, n, scale=k ** -0.5, dtype=bf16)
        call = lambda: kdense.dense_matmul(x, wt)  # noqa: E731
        out, want = call(), kdense.dense_matmul_plain(x, wt)
        report("dense", label, out, want, bf16_ulp(want.float().abs().max().item()), call,
               lambda: torch.matmul(x, wt))

    f32 = torch.float32
    ffn("smoke decode M=3 K=128 F=256 f32 silu", 3, 128, 256, f32)
    ffn("smoke prefill M=45 K=128 F=256 f32 silu", 45, 128, 256, f32)
    ffn("decode M=3 K=2048 F=11008 f32 silu", 3, 2048, 11008, f32)
    ffn("prefill M=48 K=2048 F=11008 f32 silu", 48, 2048, 11008, f32)
    ffn("M=5 K=70 F=50 f32 gelu (ragged)", 5, 70, 50, f32, "gelu")
    ffn("M=20 K=130 F=77 f32 gelu (ragged)", 20, 130, 77, f32, "gelu")
    ffn("M=100 K=200 F=96 f32 relu (two row tiles)", 100, 200, 96, f32, "relu")
    ffn("decode M=3 K=2048 F=11008 f32 unaligned w", 3, 2048, 11008, f32, offset=1)
    ffn("prefill M=48 K=2048 F=11008 f32 unaligned w", 48, 2048, 11008, f32, offset=1)
    ffn("decode M=3 K=2048 F=11008 bf16 silu", 3, 2048, 11008, bf16)
    ffn("prefill M=48 K=2048 F=11008 bf16 silu", 48, 2048, 11008, bf16)
    dense("q decode M=3 2048->2048 bf16", 3, 2048, 2048)
    dense("q prefill M=48 2048->2048 bf16", 48, 2048, 2048)
    dense("down decode M=3 11008->2048 bf16", 3, 11008, 2048)
    pre = ms["smoke prefill M=45 K=128 F=256 f32 silu"]
    dec = ms["smoke decode M=3 K=128 F=256 f32 silu"]
    print(f"  smoke decoder per plan call (2 layers, one ffn_gateup each): prefill "
          f"{2 * pre:.4f} ms, decode {2 * dec:.4f} ms (device)")


if __name__ == "__main__":
    sys.exit(main())
