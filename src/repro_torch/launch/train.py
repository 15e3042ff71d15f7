"""End-to-end training launcher (a port of ``repro.launch.train``).

Runs the paper's full pipeline with ``--prune``: ADMM training (the
penalty every step, a Z/U update every ``--admm-every`` steps) -> hard
prune after step ``int(steps * hard_prune_at)`` -> masked fine-tune; plus
checkpoint / resume (atomic, keep-N), a preemption-safe exit, a straggler
log, gradient accumulation and deterministic data with a checkpointed
cursor.  ``--arch`` takes every arch of the zoo, as in JAX.  The flags are
the JAX launcher's, plus ``--device`` (default ``cuda``; it raises without a
GPU, ``--device cpu`` runs here).  Params are drawn from a
``torch.Generator`` on the chosen device.

The steps run plain PyTorch autograd, as the JAX package trains with plain
XLA: no kernel of the port runs in training.  The kernels take over when
the hard-pruned model is compiled for serving
(``apply_masks(params, masks)`` -> ``optimize(build_decoder_graph(...),
masks, structures)`` -> ``compile_plan``).

Example (CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b --smoke \\
      --steps 20 --batch 8 --seq 32 --prune --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import torch

from ..configs import ARCH_IDS, get_config, smoke_config
from ..convert import resolve_device
from ..core.pruning import AdmmConfig, Block, Column, PrunePlan, hard_prune, tree_sparsity_report
from ..data.pipeline import PipelineState, SyntheticPipeline
from ..models import get_model
from ..training.checkpoint import CheckpointManager
from ..training.fault_tolerance import PreemptionHandler, StragglerMonitor
from ..training.optimizer import AdamWConfig
from ..training.train_loop import TrainState, init_train_state, make_train_step
from ..utils.flops import param_counts

__all__ = ["default_prune_plan", "build_parser", "train", "main"]


def default_prune_plan(sparsity: float = 0.5) -> PrunePlan:
    """The paper's recipe mapped to transformer weights: column pruning for
    the FFN in-projections (the style-transfer recipe), 64 x 64 block
    pruning for the attention q / o projections.  As in JAX, the globs
    match no MoE expert stack (``['moe']['experts']`` stays dense), nothing
    in Mamba-2, and no ``w_q`` under q-LoRA."""
    return PrunePlan.from_rules(
        [
            ("*ffn*w_gate*['w']", Column(sparsity)),
            ("*ffn*w_up*['w']", Column(sparsity)),
            ("*attn*w_q*['w']", Block(sparsity, bm=64, bn=64)),
            ("*attn*w_o*['w']", Block(sparsity, bm=64, bn=64)),
        ],
        min_size=16384,
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--prune", action="store_true")
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--admm-every", type=int, default=10)
    ap.add_argument("--hard-prune-at", type=float, default=0.6,
                    help="fraction of steps before hard prune + masked tune")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a GPU)")
    return ap


class _Clock:
    """Per-step device time: CUDA events on the card (read after the run,
    no sync inside it), the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks: List[Any] = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> List[float]:
        """Milliseconds between consecutive marks (synchronizes once)."""
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def _peak(dev: torch.device) -> Optional[int]:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def _reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _to_device(batch: Dict[str, Any], dev: torch.device) -> Dict[str, torch.Tensor]:
    if dev.type == "cuda":  # pinned + non-blocking: the copy is no host sync
        return {k: torch.from_numpy(v).pin_memory().to(dev, non_blocking=True)
                for k, v in batch.items()}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def train(args: argparse.Namespace, cfg, params, dev: torch.device, log=print,
          on_hard_prune=None) -> Dict[str, Any]:
    """The launcher's loop on ``params`` (updated in place).  Returns a
    report: ``history`` (per step: phase, whether the Z/U update ran, device
    ms, and the scalar metrics), ``peak_bytes`` per phase (``None`` on the
    CPU), ``n_updates``, the hard prune's ``sparsity`` report, the final
    ``state`` and ``masks``, ``cfg``, ``device``, and ``param_counts``
    (``utils.flops``: total and active parameters, the N of a model-FLOPs
    utilization).  ``on_hard_prune(params, masks)``, when given, sees the
    hard prune's output before the fine-tune."""
    model = get_model(cfg, device=dev)
    pipe = SyntheticPipeline(cfg, batch=args.batch, seq=args.seq + 1, seed=args.seed)

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5))
    admm_cfg = (AdmmConfig(rho=1e-2, rho_ramp=1.2, rho_max=1.0, update_every=args.admm_every)
                if args.prune else None)
    plan = default_prune_plan(args.sparsity) if args.prune else None

    counts = param_counts(cfg, params)
    peaks: Dict[str, Optional[int]] = {}
    _reset_peak(dev)
    state = init_train_state(params, opt_cfg, admm_cfg=admm_cfg, prune_plan=plan)
    del params  # the state holds them: a hard prune then frees the raw weights
    peaks["init"] = _peak(dev)
    step_fn = make_train_step(model.loss, opt_cfg, admm_cfg=admm_cfg, accum=args.accum)

    mgr = CheckpointManager(args.ckpt, save_every=args.save_every) if args.ckpt else None
    start_step = 0
    if mgr:
        restored = mgr.restore_latest((state, pipe.state.to_dict()))
        if restored:
            (state, data_state), start_step = restored
            pipe.state = PipelineState.from_dict({k: int(v) for k, v in data_state.items()})
            log(f"resumed from step {start_step}")

    hard_at = int(args.steps * args.hard_prune_at) if args.prune else -1
    mon = StragglerMonitor(
        on_straggler=lambda s, dt, med: log(
            f"  [straggler] step {s}: {dt:.2f}s vs median {med:.2f}s"))
    clock = _Clock(dev)
    history: List[Dict[str, Any]] = []
    masks, sparsity_rep, n_updates = None, None, 0
    phase = "admm" if args.prune else "dense"
    _reset_peak(dev)
    with PreemptionHandler() as pre:
        for step in range(start_step, args.steps):
            mon.start_step()
            batch = _to_device(pipe.next(), dev)
            clock.mark()
            n_before = state.admm.n_updates if state.admm is not None else 0
            state, metrics = step_fn(state, batch)
            clock.mark()
            dt = mon.end_step()
            history.append(dict(step=step, phase=phase, metrics=metrics, update=(
                state.admm is not None and state.admm.n_updates > n_before)))
            if step % 10 == 0 or step == args.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                log(f"step {step:5d} loss={m.get('loss', 0):.4f} ce={m.get('ce', 0):.4f} "
                    + (f"residual={m.get('primal_residual', 0):.3f} " if args.prune else "")
                    + f"({dt:.2f}s)")
            if args.prune and step == hard_at:
                peaks[phase] = _peak(dev)
                n_updates = state.admm.n_updates
                _reset_peak(dev)
                pruned, masks = hard_prune(state.params, state.admm)
                # the ADMM state goes: Z / U are freed before the fine-tune
                state = TrainState(params=pruned, opt=state.opt, admm=None, masks=masks)
                step_fn = make_train_step(model.loss, opt_cfg, accum=args.accum)
                sparsity_rep = tree_sparsity_report(pruned, masks)
                peaks["hard_prune"] = _peak(dev)
                if on_hard_prune is not None:
                    on_hard_prune(pruned, masks)
                log(f"  [hard prune] global sparsity over pruned leaves: "
                    f"{sparsity_rep['pruned_global']:.3f}; masked fine-tune begins")
                phase = "masked"
                _reset_peak(dev)
            if mgr:
                mgr.maybe_save(step + 1, (state, pipe.state.to_dict()), force=pre.should_stop)
            if pre.should_stop:
                log(f"preempted at step {step}; checkpoint saved; exiting cleanly")
                break
    peaks[phase] = _peak(dev)
    for h, ms in zip(history, clock.ms()[::2]):  # every step's own two marks
        h["ms"] = ms
        h.update({k: float(v) for k, v in h.pop("metrics").items()})
    if state.admm is not None:
        n_updates = state.admm.n_updates
    if dev.type == "cuda":
        log("  [memory] peak allocated GB per phase: " + ", ".join(
            f"{k} {v / 1e9:.3f}" for k, v in peaks.items()))
    log(f"done; median step {mon.median:.2f}s, stragglers: {len(mon.straggler_steps)}")
    return dict(cfg=cfg, device=dev, history=history, peak_bytes=peaks, n_updates=n_updates,
                sparsity=sparsity_rep, state=state, masks=masks, hard_at=hard_at,
                param_counts=counts)


def main(argv=None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = get_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(args.seed))
    return train(args, cfg, params, dev)


if __name__ == "__main__":
    main()
