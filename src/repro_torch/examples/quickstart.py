"""Quickstart: the paper's pipeline end to end on one weight matrix (a twin
of the JAX package's ``examples/quickstart.py``).

    ADMM structured pruning -> compact storage -> matrix reorder ->
    block-sparse kernel execution

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card the last stage launches the hand-written ``bsr_matmul`` kernel
(its f32 CUDA-core route: M = 128, 256 x 256 in 64 x 64 blocks); on the CPU
it runs the kernel's plain version.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..convert import resolve_device
from ..core.pruning import (
    AdmmConfig, Block, PrunePlan, admm_init, admm_penalty, admm_update,
    convergence_metrics, hard_prune, project,
)
from ..core.sparse import PBCSR, apply_column_perm, balance_stats, block_mask, plan_reorder
from ..kernels import ops, ref

__all__ = ["D", "BM", "make_problem", "teacher_of", "task_loss", "admm_prune",
           "compile_storage", "run_bsr", "main"]

D = 256
BM = 64  # 64 x 64 blocks
SEED = 0
STEPS, UPDATE_EVERY, LR = 300, 10, 2e-2
ADMM = dict(rho=0.3, rho_ramp=1.1, rho_max=3.0, update_every=1)
MAX_BANDS = 3
M_KERNEL = 128  # rows of x through the block-sparse kernel


def make_problem() -> Dict[str, np.ndarray]:
    """The toy task's arrays (numpy, f32): a dense draw ``raw [D, D]`` whose
    ``Block(0.5, 64, 64)`` projection is the teacher, inputs ``x [1024, D]``
    and the student's start ``w0 [D, D]`` (normal x 0.1)."""
    rng = np.random.default_rng(SEED)
    return dict(raw=rng.standard_normal((D, D)).astype(np.float32),
                x=rng.standard_normal((1024, D)).astype(np.float32),
                w0=(rng.standard_normal((D, D)) * 0.1).astype(np.float32))


def teacher_of(raw: torch.Tensor) -> torch.Tensor:
    return project(raw, Block(0.5, bm=BM, bn=BM))[0]


def task_loss(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x @ w - y) ** 2)


def admm_prune(w0: torch.Tensor, x: torch.Tensor, y: torch.Tensor, *, steps: int = STEPS
               ) -> Dict[str, Any]:
    """ADMM block pruning (paper section 2): ``steps`` SGD steps on the task
    loss + the ADMM penalty, a Z/U update every ``UPDATE_EVERY`` steps,
    then the hard prune.  Returns the params, the ADMM state, the primal
    residual, the pruned weight and its mask, and the task loss before and
    after the hard prune."""
    plan = PrunePlan.from_rules([("*", Block(0.5, bm=BM, bn=BM))], min_size=16)
    cfg = AdmmConfig(**ADMM)
    params = {"w": w0.clone()}
    state = admm_init(params, plan, cfg)
    for it in range(steps):
        w = params["w"].requires_grad_(True)
        (g,) = torch.autograd.grad(task_loss(w, x, y) + admm_penalty({"w": w}, state), [w])
        params = {"w": (w - LR * g).detach()}
        if it % UPDATE_EVERY == UPDATE_EVERY - 1:
            state = admm_update(params, state, cfg)
    residual = float(convergence_metrics(params, state)["primal_residual"])
    pruned, masks = hard_prune(params, state)
    with torch.no_grad():
        loss_dense = float(task_loss(params["w"], x, y))
        loss_pruned = float(task_loss(pruned["w"], x, y))
    return dict(params=params, state=state, primal_residual=residual, w=pruned["w"],
                mask=masks["w"], loss_dense=loss_dense, loss_pruned=loss_pruned)


def compile_storage(w: torch.Tensor, mask: torch.Tensor) -> Dict[str, Any]:
    """The compiler's storage half (paper section 3): the kept-block map,
    its balance, the matrix reorder into at most ``MAX_BANDS`` bands, the
    permuted weight and mask, and their PBCSR packing."""
    bmask = block_mask(mask, BM, BM).cpu().numpy()
    balance = balance_stats(bmask)
    rplan = plan_reorder(bmask, max_bands=MAX_BANDS, bm=BM, bn=BM)
    w_perm = apply_column_perm(w, rplan.order, BM)
    m_perm = apply_column_perm(mask, rplan.order, BM)
    fmt = PBCSR.from_dense(w_perm, m_perm, BM, BM)
    return dict(bmask=bmask, balance=balance, plan=rplan, w_perm=w_perm, m_perm=m_perm,
                fmt=fmt, bands=[(b.start, b.stop, b.count) for b in rplan.bands],
                dense_bytes=w.numel() * w.element_size())


def run_bsr(x: torch.Tensor, fmt: PBCSR, bands: Sequence, w_perm: torch.Tensor
            ) -> Dict[str, Any]:
    """``x @ W`` through the block-sparse kernel (one launch a band) against
    the dense product with the permuted weight."""
    got = ops.bsr_matmul(x, fmt.values, fmt.block_rows, bands=bands)
    want = ref.matmul_ref(x, w_perm)
    return dict(got=got, want=want, max_err=float((got - want).abs().max()))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ---- 1. a toy task: recover a block-sparse teacher ----------------------
    arrays = make_problem()
    raw, x, w0 = (torch.from_numpy(arrays[k]).to(dev) for k in ("raw", "x", "w0"))
    teacher = teacher_of(raw)
    y = x @ teacher

    # ---- 2. ADMM pruning (paper section 2) -----------------------------------
    pr = admm_prune(w0, x, y)
    print("primal residual:", pr["primal_residual"])
    print("task loss dense -> pruned:", pr["loss_dense"], "->", pr["loss_pruned"])

    # ---- 3. compiler: storage + reorder (paper section 3) ----------------------
    st = compile_storage(pr["w"], pr["mask"])
    print("balance before reorder:", st["balance"])
    fmt = st["fmt"]
    print(f"packed blocks: {fmt.n_blocks} (pad {fmt.padded_blocks}); "
          f"bytes {fmt.nbytes} vs dense {st['dense_bytes']}")

    # ---- 4. block-sparse execution (the CUDA kernel on the card) ------------
    xk = x[:M_KERNEL].contiguous()
    run = run_bsr(xk, fmt, st["bands"], st["w_perm"])
    print("BSR kernel vs dense max err:", run["max_err"])
    print("OK")
    return dict(device=str(dev), primal_residual=pr["primal_residual"],
                loss_dense=pr["loss_dense"], loss_pruned=pr["loss_pruned"],
                balance=st["balance"], n_blocks=fmt.n_blocks, padded_blocks=fmt.padded_blocks,
                nbytes=fmt.nbytes, dense_bytes=st["dense_bytes"], bands=st["bands"],
                bsr_max_err=run["max_err"], x=xk, fmt=fmt, out=run["got"])


if __name__ == "__main__":
    main()
