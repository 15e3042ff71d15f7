"""End-to-end training example: train a ~100M-param qwen2.5-family LM with the full
production stack -- ADMM pruning phases, checkpointing, preemption handling,
deterministic data (a twin of the JAX package's
``examples/train_lm_100m.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm_100m --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_lm_100m --tiny --steps 40 --device cpu

The config is the qwen2.5 family scaled to ~100M params (8 layers, d=512,
vocab 32k, f32); ``--tiny`` is 2 layers at d=128.  With ``--prune`` the
steps run ADMM (a Z/U update every 20 steps), the hard prune follows step
``int(0.6 * steps)``, and the rest fine-tune under the masks.

One deliberate difference from the JAX script: on the card each step
synchronizes before ``StragglerMonitor.end_step()``, so the step times and
tok/s measure the step's device work, not the enqueue of asynchronous
launches.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..configs import get_config
from ..convert import resolve_device
from ..core.pruning import AdmmConfig, hard_prune, tree_sparsity_report
from ..data.pipeline import SyntheticPipeline
from ..launch.train import default_prune_plan
from ..models import get_model
from ..training.checkpoint import CheckpointManager
from ..training.fault_tolerance import PreemptionHandler, StragglerMonitor
from ..training.optimizer import AdamWConfig
from ..training.train_loop import TrainState, init_train_state, make_train_step
from ..utils.tree import leaves

__all__ = ["lm_100m", "lm_tiny", "build_parser", "train", "main"]


def lm_100m():
    base = get_config("qwen2.5-3b")
    return dataclasses.replace(
        base, name="qwen2.5-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=2, d_ff=1536, vocab=32768, dtype="float32",
    )


def lm_tiny():
    base = get_config("qwen2.5-3b")
    return dataclasses.replace(
        base, name="qwen2.5-tiny", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab=512, dtype="float32",
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--prune", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def _batch(b, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def train(args: argparse.Namespace, cfg, params, dev: torch.device,
          log: Callable[[str], None] = print) -> Dict[str, Any]:
    """The script's loop on ``params`` (updated in place).  Returns the
    per-step ``ce`` / ``lr`` / ``grad_norm`` / seconds, the hard prune's
    step and sparsity report, the final state and masks, the median step
    seconds, and whether a preemption stopped it."""
    model = get_model(cfg, device=dev)
    opt_cfg = AdamWConfig(lr=3e-4 if not args.tiny else 2e-3,
                          total_steps=args.steps, warmup_steps=max(args.steps // 20, 5))
    admm_cfg = (AdmmConfig(rho=1e-2, rho_ramp=1.2, rho_max=1.0, update_every=20)
                if args.prune else None)
    plan = default_prune_plan(0.5) if args.prune else None
    state = init_train_state(params, opt_cfg, admm_cfg=admm_cfg, prune_plan=plan)
    step = make_train_step(model.loss, opt_cfg, admm_cfg=admm_cfg)
    pipe = SyntheticPipeline(cfg, batch=args.batch, seq=args.seq + 1, seed=0)
    mgr = CheckpointManager(args.ckpt, save_every=50) if args.ckpt else None
    mon = StragglerMonitor()
    hard_at = int(args.steps * 0.6)
    toks = args.batch * args.seq
    history: List[Dict[str, float]] = []
    masks, sparsity, preempted = None, None, False

    with PreemptionHandler() as pre:
        t0 = time.time()
        for i in range(args.steps):
            mon.start_step()
            batch = _batch(pipe.next(), dev)
            state, m = step(state, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            mon.end_step()
            history.append(dict(ce=float(m["ce"]), lr=float(m["lr"]),
                                grad_norm=float(m["grad_norm"]), seconds=mon.times[-1]))
            if i % 20 == 0 or i == args.steps - 1:
                h = history[-1]
                log(f"step {i:4d} ce={h['ce']:.4f} lr={h['lr']:.2e} "
                    f"gnorm={h['grad_norm']:.2f} "
                    f"({toks / max(mon.times[-1], 1e-9):.0f} tok/s)")
            if args.prune and i == hard_at:
                pruned, masks = hard_prune(state.params, state.admm)
                sparsity = tree_sparsity_report(pruned, masks)
                log(f"hard prune @ step {i}: sparsity={sparsity['pruned_global']:.2f}")
                state = TrainState(params=pruned, opt=state.opt, admm=None, masks=masks)
                step = make_train_step(model.loss, opt_cfg)
            if mgr:
                mgr.maybe_save(i + 1, (state, pipe.state.to_dict()), force=pre.should_stop)
            if pre.should_stop:
                log("preempted; clean exit")
                preempted = True
                break
        wall = time.time() - t0
    if not preempted:
        log(f"trained {args.steps} steps in {wall:.1f}s; median step {mon.median:.2f}s")
    return dict(history=history, hard_at=hard_at if args.prune else None, sparsity=sparsity,
                state=state, masks=masks, median_step_s=mon.median, wall_s=wall,
                tokens_per_step=toks, preempted=preempted, data_state=pipe.state.to_dict())


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":  # an f32 model: true f32 matmuls
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = lm_tiny() if args.tiny else lm_100m()
    params = get_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(x.numel() for x in leaves(params))
    print(f"{cfg.name}: {n_params / 1e6:.1f}M params")
    report = train(args, cfg, params, dev)
    report.update(device=str(dev), cfg=cfg, n_params=n_params)
    return report


if __name__ == "__main__":
    main()
