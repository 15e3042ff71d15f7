"""The port's kernels: hand-written CUDA kernels (``csrc/``), each with its
wrapper, plain PyTorch version and launch counter in the module of the same
name (``conv2d``, ``dense_matmul``, ``fused_elementwise``,
``quant_matmul``, ``flash_attention``, ``fused_ffn``, ``bsr_matmul``), and
the public ``ops`` layer the executor calls.

The package exports the JAX package's names: ``ref`` and the ``ops`` entry
points.  Three of those share their name with a kernel module
(``bsr_matmul``, ``conv2d``, ``fused_elementwise``): there the name stays
the module, which is made callable as the ``ops`` entry point, so
``from repro_torch.kernels import conv2d`` gives the module and
``conv2d(x, w, ...)`` runs ``ops.conv2d``.  (``interpret_default``, a Pallas
interpret-mode switch, has no counterpart: the device of the tensors picks
the route.)
"""

import sys
import types

from . import ref
from .ops import attention, col_matmul, ffn_gateup, matmul, qmatmul


class _KernelModule(types.ModuleType):
    """A kernel module that, called, runs the ``ops`` entry point of its
    name."""

    def __call__(self, *args, **kwargs):
        from . import ops

        return getattr(ops, self.__name__.rsplit(".", 1)[1])(*args, **kwargs)


for _name in ("bsr_matmul", "conv2d", "fused_elementwise"):
    sys.modules[f"{__name__}.{_name}"].__class__ = _KernelModule
del _name

__all__ = [
    "attention",
    "bsr_matmul",
    "col_matmul",
    "conv2d",
    "ffn_gateup",
    "fused_elementwise",
    "matmul",
    "qmatmul",
    "ref",
]
