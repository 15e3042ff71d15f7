"""Fused elementwise step program over ``[M, D]``: CUDA kernel + plain version.

Replaces the TPU kernel
``repro/kernels/fused_elementwise.py:fused_elementwise_kernel`` (wrapper
``fused_elementwise``).  ``fused_elementwise(x, sides, steps, norm_params)``
runs a kernel-local step program over a 2-D ``x [M, D]`` in one pass:

* ``("activation", fn)``  -- apply ``fn`` to the running value
* ``("add", slot)`` / ``("mul", slot)`` -- side operand ``slot`` (``[M, D]``)
* ``("norm", slot, eps)`` -- layer norm over D with scale/bias pair ``slot``

The kernel (``csrc/fused_elementwise.cu``) reads ``x`` and each side once and
writes the output once.  Layer norm takes the mean, then the mean of squared
deviations, in f32 over exactly D columns -- the TPU kernel masked its lane
padding past ``d_true``; here nothing is padded, so D is the true width.

What bounds it on an H100: a few FLOPs per element, so device memory; the
design touches each byte once.  Routing: a CPU tensor takes
:func:`fused_elementwise_plain`, a CUDA tensor launches the kernel or
raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import _build
from .ref import fused_elementwise_ref

__all__ = ["fused_elementwise", "fused_elementwise_plain"]

#: kernel launches made by :func:`fused_elementwise` (CUDA route only)
launches = 0


def fused_elementwise_plain(
    x: torch.Tensor,
    sides: Sequence[torch.Tensor] = (),
    steps: Sequence[Tuple] = (),
    norm_params: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments)."""
    return fused_elementwise_ref(x, sides, steps, norm_params)


def fused_elementwise(
    x: torch.Tensor,
    sides: Sequence[torch.Tensor] = (),
    steps: Sequence[Tuple] = (),
    norm_params: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
) -> torch.Tensor:
    """Run ``steps`` over 2-D ``x [M, D]``; see the module doc."""
    global launches
    if x.dim() != 2:
        raise ValueError(f"fused_elementwise: x must be 2-D, got {tuple(x.shape)}")
    m, d = x.shape
    for s in sides:
        if s.shape != x.shape:
            raise ValueError(f"fused_elementwise: side {tuple(s.shape)} != {tuple(x.shape)}")
    for scale, bias in norm_params:
        if tuple(scale.shape) != (d,) or tuple(bias.shape) != (d,):
            raise ValueError(f"fused_elementwise: norm params must be [{d}]")
    steps = tuple(tuple(s) for s in steps)
    _build.validate_program(steps, len(sides), len(norm_params), norms_ok=True)
    named = {f"side{i}": s for i, s in enumerate(sides)}
    for i, (scale, bias) in enumerate(norm_params):
        named[f"scale{i}"], named[f"bias{i}"] = scale, bias
    dev = _build.kernel_device("fused_elementwise", x=x, **named)
    if dev.type == "cpu":
        return fused_elementwise_plain(x, sides, steps, norm_params)
    lib = _build.lib()
    if any(s[0] == "norm" for s in steps) and d > lib.repro_fused_elementwise_max_d():
        raise ValueError(f"fused_elementwise: layer norm over D={d} exceeds the row kernel's "
                         f"{lib.repro_fused_elementwise_max_d()} columns")
    out = torch.empty((m, d), dtype=torch.float32, device=dev)
    prog = _build.encode_program(steps)
    side_ptrs = _build.pointer_array(sides)
    norm_ptrs = _build.pointer_array([t for pair in norm_params for t in pair])
    err = lib.repro_fused_elementwise(
        x.data_ptr(), out.data_ptr(), m, d,
        prog["n"], _build.addr(prog["prog"]), _build.addr(prog["eps"]),
        len(sides), _build.addr(side_ptrs), len(norm_params), _build.addr(norm_ptrs),
        _build.stream_handle(),
    )
    _build.check(err, "fused_elementwise")
    launches += 1
    return out
