"""Versioned plan rollout: zero-loss hot-swap of a served plan (a port of
``repro/serving/rollout.py``).

A re-pruned / re-quantized / re-tuned plan must be installable into a live
:class:`~repro_torch.serving.scheduler.AsyncPlanServer` without dropping a
single request.  The unit of bookkeeping is :class:`PlanVersion` -- one
concrete runnable (plan + params + :class:`BatchedPlan`) with an
outstanding-request ledger.  Both rollout *versions* (v0, v1, ... of the
primary) and degradation *variants* (the ladder's registered cheaper
fallback) are PlanVersions, which is what lets the scheduler form every
macro-batch over requests that share one exact runnable:

* every request is pinned to its PlanVersion **at admission** and executes
  on it no matter what is installed afterwards;
* :meth:`AsyncPlanServer.swap_plan` probes the incoming version first
  (execute a probe batch on the plan's device, require finite outputs,
  optionally bound the parity drift vs the live version) -- a failed probe
  **rolls back**: the incoming version is discarded, the live version keeps
  serving, and the rollback is counted
  (``serving_swap_total{plan, event="rolled_back"}``);
* a successful swap atomically routes *new* admissions to the new version
  while the old version keeps draining its admitted work; when its
  outstanding count hits zero it is **retired** (counted + traced), so a
  long-running server holds exactly one live version per plan at rest.

State machine of one version::

    install -> probing -> active -> draining -> retired
                  |
                  +-> rolled_back (probe failed; never served traffic)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

__all__ = ["PlanVersion", "SwapError", "probe_version", "version_health"]


class SwapError(RuntimeError):
    """Raised by ``swap_plan`` when the incoming version fails its probe;
    the previously active version is still serving (rollback)."""


@dataclasses.dataclass(eq=False)
class PlanVersion:
    """One runnable version of a served plan.  ``outstanding`` counts the
    requests admitted to this version that have not yet reached a terminal
    verdict (resolved / failed / shed) -- the drain signal for retirement.
    Mutated only under the owning server's lock."""

    plan: Any
    params: Any
    batched: Any  # BatchedPlan at this version's batch size
    version: int
    variant: str = "primary"
    admitted: int = 0
    outstanding: int = 0

    @property
    def batch_size(self) -> int:
        return self.batched.batch_size

    def label(self) -> str:
        """Stable id for stats/trace: ``v<version>`` for primaries,
        ``<variant>`` for registered degradation variants."""
        return f"v{self.version}" if self.variant == "primary" else self.variant


def probe_version(
    version: PlanVersion,
    input_spec: Optional[Sequence[Tuple[Tuple[int, ...], torch.dtype]]],
    probe_frames: Optional[Sequence[Any]] = None,
    *,
    reference: Optional[PlanVersion] = None,
    parity_tol: Optional[float] = None,
) -> None:
    """Execute one probe batch through ``version`` on its plan's device and
    raise :class:`SwapError` if it cannot serve: the chunk raises, an output
    is non-finite, or (when ``parity_tol`` is given) it drifts more than the
    tolerance from the live ``reference`` version on the same frames.

    ``probe_frames`` beats the synthesized zeros probe; with neither probe
    frames nor an input spec there is nothing to run, which is itself a
    refusal -- a swap must never install an unprobed version."""
    device = version.plan.device
    if probe_frames is None:
        if input_spec is None:
            raise SwapError(
                "cannot probe: no probe_frames given and no input_spec "
                "known -- refusing to install an unprobed version"
            )
        probe_frames = [torch.zeros(shape, dtype=dtype) for shape, dtype in input_spec]
    frames = tuple(torch.as_tensor(f).to(device)[None] for f in probe_frames)
    try:
        out = version.batched.run_chunk(version.params, *frames)
    except Exception as e:
        raise SwapError(
            f"probe batch failed on incoming version "
            f"{version.label()}: {type(e).__name__}: {e}"
        ) from e
    outs = out if isinstance(out, tuple) else (out,)
    for i, o in enumerate(outs):
        if o.is_floating_point() and not bool(torch.isfinite(o).all()):
            raise SwapError(
                f"probe output {i} of incoming version {version.label()} "
                f"is non-finite"
            )
    if parity_tol is not None and reference is not None:
        want = reference.batched.run_chunk(reference.params, *frames)
        wants = want if isinstance(want, tuple) else (want,)
        for i, (o, w) in enumerate(zip(outs, wants)):
            err = float((o.float() - w.float()).abs().max())
            if err > parity_tol:
                raise SwapError(
                    f"probe output {i} of incoming version "
                    f"{version.label()} drifts {err:.3e} from the live "
                    f"version (tolerance {parity_tol:.3e})"
                )


def version_health(versions: Dict[str, "PlanVersion"]) -> Dict[str, Any]:
    """``health()`` fragment for a plan's non-active versions/variants."""
    return {
        label: {
            "version": v.version,
            "variant": v.variant,
            "admitted": v.admitted,
            "outstanding": v.outstanding,
        }
        for label, v in versions.items()
    }
