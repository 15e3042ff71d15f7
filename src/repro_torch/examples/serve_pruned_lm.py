"""End-to-end serving example: batched requests against a pruned LM (a twin of
the JAX package's ``examples/serve_pruned_lm.py``).

Pipeline: init a small qwen-family model -> one-shot structured prune
(``launch.train.default_prune_plan``: column on the FFN in-projections,
64 x 64 blocks on the attention q / o) -> masked weights -> serve batched
generations + a continuous-batching queue.

    PYTHONPATH=src python -m repro_torch.examples.serve_pruned_lm [--device cpu]

``RequestScheduler.run`` returns only the requests still holding a slot, as
the JAX package's does, so the last line counts those.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import get_config
from ..convert import resolve_device
from ..core.pruning import project
from ..launch.train import default_prune_plan
from ..models import get_model
from ..serving.engine import Engine, Request, RequestScheduler
from ..utils.tree import map_with_path

__all__ = ["small_lm", "prune", "make_requests", "main"]

BATCH, MAX_LEN, PROMPT_LEN, NEW_TOKENS, N_REQUESTS, SEED = 4, 96, 16, 24, 10, 0


def small_lm():
    base = get_config("qwen2.5-3b")
    return dataclasses.replace(
        base, name="qwen2.5-serve-demo", n_layers=4, d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab=4096, dtype="float32",
    )


def prune(params) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """One-shot structured prune at 50% of every leaf ``default_prune_plan``
    assigns (looked up by the port's leaf paths, spelled as
    ``jax.tree_util.keystr``).  Returns the pruned params and the mask of
    each pruned leaf by path."""
    assigned = default_prune_plan(0.5).assign(params)
    masks: Dict[str, torch.Tensor] = {}

    def visit(path, w):
        st = assigned.get(path)
        if st is None:
            return w
        pw, masks[path] = project(w, st)
        return pw.to(w.dtype)

    return map_with_path(visit, params), masks


def make_requests(rng: np.random.Generator, vocab: int, n: int = N_REQUESTS) -> List[Request]:
    """``n`` requests of 4..15 prompt tokens and 4..11 new tokens, drawn as
    the JAX script draws them."""
    return [Request(rid=rid,
                    prompt=rng.integers(0, vocab, int(rng.integers(4, 16))).astype(np.int32),
                    max_new=int(rng.integers(4, 12)))
            for rid in range(n)]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":  # f32 serving: true f32 matmuls
        torch.backends.cuda.matmul.allow_tf32 = False

    cfg = small_lm()
    model = get_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    params, masks = prune(params)
    print(f"pruned {len(masks)} weight matrices (column/block @ 50%)")

    engine = Engine(model, params, batch_size=BATCH, max_len=MAX_LEN)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab, (BATCH, PROMPT_LEN)).astype(np.int32)
    t0 = time.perf_counter()
    res = engine.generate(torch.from_numpy(prompts), NEW_TOKENS)
    dt = time.perf_counter() - t0  # generate returns host arrays: the card is done
    tok_s = BATCH * NEW_TOKENS / dt
    print(f"batched generate: {res.tokens.shape} in {dt:.2f}s ({tok_s:.1f} tok/s)")

    sched = RequestScheduler(engine)
    for req in make_requests(rng, cfg.vocab):
        sched.submit(req)
    t0 = time.perf_counter()
    served = sched.run()
    sched_s = time.perf_counter() - t0
    finished = sum(r.done for r in served)
    print(f"continuous batching: {finished} finished in slots, "
          f"queue drained={not sched.queue}, {sched_s:.2f}s")
    print("OK")
    return dict(device=str(dev), cfg=cfg, params=params, masks=masks, prompts=prompts,
                tokens=res.tokens, generate_s=dt, tok_per_s=tok_s, served=served,
                finished=finished, queue_drained=not sched.queue, scheduler_s=sched_s)


if __name__ == "__main__":
    main()
