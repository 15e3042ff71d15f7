#!/usr/bin/env python3
"""Save, or compare, the demo apps' f32 and INT8 kernel-plan outputs on the card.

    PYTHONPATH=src python tools/app_outputs.py --out build/app_outputs.pt
    python tools/app_outputs.py --compare a.pt b.pt

For each demo app (base 32, weights from ``torch.Generator().manual_seed(0)``,
sparsity 0.5 with the app's recipe, as ``chip_smoke.py`` builds them): the
f32 kernel plan, then the INT8 plan (calibrated on two seeded batches of
the f32 reference plan, the ``quantize`` pass with the app's skip sets, the
``quant`` backend), each run on four seeded 256x256 frames; the outputs and
the kernel launches of each plan call go to ``--out``.  Run it once with
the ``src`` of each of two trees on ``PYTHONPATH`` (each builds its own
kernels beside its ``src``), then ``--compare`` the files: it prints, per
output, whether the two are ``torch.equal`` and their largest difference,
and exits non-zero unless every output and launch count is equal.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

SEED, BASE, SIZE, BATCH = 0, 32, 256, 4


def run(out_path: str) -> None:
    from repro_torch.core.graph import PassContext, PassManager, compile_plan
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import (APP_ACT_SKIP, APP_INPUT_CHANNELS, APP_QUANT_SKIP, APPS,
                                        app_masks)
    from repro_torch.quant import calibrate_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    saved = {}
    for app in sorted(APPS):
        g = APPS[app](torch.Generator().manual_seed(SEED), base=BASE, device="cuda")
        masks, structures = app_masks(g, app, sparsity=0.5)
        go = PassManager().run(g, PassContext(masks=masks, structures=structures))
        shape = (BATCH, APP_INPUT_CHANNELS[app], SIZE, SIZE)
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda")
        calib = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda")
                 for _ in range(2)]
        table = calibrate_plan(compile_plan(go, backend="reference", device="cuda"), go.params,
                               calib)
        gq = PassManager(("quantize",)).run(go, PassContext(
            calibration=table, quant_skip=APP_QUANT_SKIP[app], act_quant_skip=APP_ACT_SKIP[app]))
        for variant, graph, backend in (("f32", go, "kernel"), ("int8", gq, "quant")):
            plan = compile_plan(graph, backend=backend, device="cuda")
            ops.reset_kernel_launches()
            with torch.no_grad():
                y = plan(graph.params, x)
            torch.cuda.synchronize()
            launches = {k: v for k, v in ops.kernel_launch_counts().items() if v}
            saved[f"{app}/{variant}"] = {"out": y.cpu(), "launches": launches}
            print(f"{app:16s} {variant:4s} out {tuple(y.shape)} launches {launches}")
    torch.save(saved, out_path)
    print(f"saved {len(saved)} outputs -> {out_path} ({torch.cuda.get_device_name(0)})")


def compare(a_path: str, b_path: str) -> int:
    a, b = torch.load(a_path), torch.load(b_path)
    ok = sorted(a) == sorted(b)
    for key in sorted(a):
        if key not in b:
            continue
        ya, yb = a[key]["out"], b[key]["out"]
        same = ya.shape == yb.shape and torch.equal(ya, yb)
        diff = (ya - yb).abs().max().item() if ya.shape == yb.shape else float("nan")
        same_launches = a[key]["launches"] == b[key]["launches"]
        ok = ok and same and same_launches
        print(f"{key:24s} torch.equal={same} max|diff|={diff:.3e} "
              f"launches equal={same_launches} {a[key]['launches']}")
    print("all equal" if ok else "DIFFERENT")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        print("app_outputs: no CUDA device", file=sys.stderr)
        return 2
    run(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
