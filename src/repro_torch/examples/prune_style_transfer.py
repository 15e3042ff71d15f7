"""Paper application demo: prune + compile the style-transfer network and
compare the three Table-1 variants on this device (a twin of the JAX
package's ``examples/prune_style_transfer.py`` and the ``bench_app`` it
calls).

Run:  PYTHONPATH=src python -m repro_torch.examples.prune_style_transfer [--device cpu]

The variants, at base 32 on one 1 x 3 x 128 x 128 frame with the paper's
recipe (``app_masks``, sparsity 0.5):

* unpruned -- ``lower(g, use_kernels=False)``: the plain-torch reference
  handlers;
* pruned -- the same function on the masked params;
* pruned + compiler -- ``optimize`` then ``compile_plan`` on the ``kernel``
  backend: on the card the conv2d and dense_matmul kernels run.  Its
  ``reference`` plan runs beside it for the agreement.  Here this column
  differs from the JAX script's: ``bench_app`` times the ``reference``
  plan under ``jax.jit``, one XLA program, and no hand-written kernel.

ms/frame is the median of 5 calls after a warm-up (CUDA events on the card,
the host clock on the CPU).  The paper's ms (a Galaxy S10) set the shape of
the table, not a bound.  FLOPs are ``utils.op_costs.OpCosts`` over the
reference plans (``torch.utils.flop_counter``'s formulas: each convolution
counted as the GEMM of its padded patches, no elementwise op).  The JAX
package's XLA cost analysis counts its own way: on this graph the port's
counts are 1.7% (unpruned) and 0.6% (compiled) above it, the cut 1.1%.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..convert import resolve_device
from ..core.graph import compile_plan, lower, optimize
from ..core.graph.ir import Graph
from ..models.cnn import PAPER_TABLE1, app_masks, build_style_transfer
from ..utils.op_costs import OpCosts
from ..utils.tree import leaves

__all__ = ["APP", "INPUT_SHAPE", "VARIANTS", "masked_params", "compile_variants",
           "count_flops", "param_bytes", "op_histogram", "time_ms", "bench", "main"]

APP = "style_transfer"
#: the JAX package's Table-1 input shape of the app (one frame)
INPUT_SHAPE = (1, 3, 128, 128)
VARIANTS = ("unpruned", "pruned", "pruned_compiler")
BASE, SPARSITY, SEED = 32, 0.5, 0
#: timed calls of each variant, after one warm-up call
REPS = 5


def masked_params(g: Graph, masks: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, Any]]:
    """The pruned variant's params: each masked node's weight times its
    mask (ADMM's output before any compiler work)."""
    return {k: ({**v, "w": v["w"] * masks[k]} if k in masks else v)
            for k, v in g.params.items()}


def compile_variants(g: Graph, masks, structures) -> Dict[str, Any]:
    """The dense function (``lower``, reference handlers), the optimized
    graph and its ``kernel`` and ``reference`` plans, on the graph's
    device."""
    dev = next(iter(leaves(g.params))).device
    go = optimize(g, masks, structures)
    return dict(dense=lower(g, use_kernels=False, device=dev), go=go,
                plan=compile_plan(go, backend="kernel", device=dev),
                ref_plan=compile_plan(go, backend="reference", device=dev))


def count_flops(fn: Callable, params, x: torch.Tensor) -> float:
    """FLOPs of one call of a plan (``OpCosts``: the flop counter's formulas
    over the aten ops it runs)."""
    with torch.no_grad(), OpCosts() as costs:
        fn(params, x)
    return float(costs.flops)


def param_bytes(params) -> int:
    return int(sum(t.numel() * t.element_size() for t in leaves(params)))


def op_histogram(g: Graph) -> Dict[str, int]:
    ops: Dict[str, int] = {}
    for n in g.nodes:
        ops[n.op] = ops.get(n.op, 0) + 1
    return ops


def time_ms(fn: Callable, *args, reps: int = REPS) -> float:
    """Median ms of ``reps`` calls after one warm-up call: CUDA events around
    each call on the card, the host clock on the CPU."""
    dev = args[-1].device
    with torch.no_grad():
        fn(*args)
        times = []
        for _ in range(reps):
            if dev.type == "cuda":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn(*args)
                times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def bench(g: Graph, x: torch.Tensor, reps: int = REPS) -> Dict[str, Any]:
    """The three variants of ``g`` on ``x`` (the JAX package's ``bench_app``
    for one app): ms/frame, FLOPs, param bytes, the agreement between the
    pruned and the pruned + compiler outputs, plan steps and peak activation
    bytes, plus the kernel plan's error against its reference plan, and
    each variant's ``(function, params)`` for a caller to time again."""
    masks, structures = app_masks(g, APP, SPARSITY)
    pm = masked_params(g, masks)
    v = compile_variants(g, masks, structures)
    dense, go, plan, ref_plan = v["dense"], v["go"], v["plan"], v["ref_plan"]
    ms = {"unpruned": time_ms(dense, g.params, x, reps=reps),
          "pruned": time_ms(dense, pm, x, reps=reps),
          "pruned_compiler": time_ms(plan, go.params, x, reps=reps)}
    with torch.no_grad():
        out_pruned = dense(pm, x)
        out = plan(go.params, x)
        out_ref = ref_plan(go.params, x)
    return dict(
        ms=ms,
        flops={"unpruned": count_flops(dense, g.params, x),
               "pruned_compiler": count_flops(ref_plan, go.params, x)},
        param_bytes={"unpruned": param_bytes(g.params), "pruned_compiler": param_bytes(go.params)},
        agreement_max_err=_max_err(out_pruned, out),
        kernel_vs_reference_err=_max_err(out, out_ref),
        reference_max=float(out_ref.abs().max()),
        paper_ms=PAPER_TABLE1[APP],
        plan_steps=len(plan.steps),
        peak_activation_bytes=ref_plan.memory_estimate(tuple(x.shape))["peak_activation_bytes"],
        op_histogram=op_histogram(go),
        out=out,
        x=x,
        variants={"unpruned": (dense, g.params), "pruned": (dense, pm),
                  "pruned_compiler": (plan, go.params)},
    )


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":  # the plans' tolerances assume true f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    g = build_style_transfer(torch.Generator().manual_seed(SEED), base=BASE, device=dev)
    x = torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal(INPUT_SHAPE).astype(
        np.float32)).to(dev)
    r = bench(g, x)
    print("variant         ms/frame   (paper ms)")
    for v in VARIANTS:
        print(f"{v:15s} {r['ms'][v]:8.2f}   ({r['paper_ms'][v]})")
    r["flop_cut"] = r["flops"]["unpruned"] / r["flops"]["pruned_compiler"]
    r["bytes_cut"] = r["param_bytes"]["unpruned"] / r["param_bytes"]["pruned_compiler"]
    print(f"compiler FLOP cut: {r['flop_cut']:.2f}x; "
          f"model bytes cut: {r['bytes_cut']:.2f}x; "
          f"output agreement vs masked-dense: {r['agreement_max_err']:.2e}")
    print("optimized graph op histogram:", r["op_histogram"])
    r["device"] = str(dev)
    return r


if __name__ == "__main__":
    main()
