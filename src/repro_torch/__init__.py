"""PyTorch + CUDA (Hopper) port of the pruning compiler in ``repro``.

The JAX package ``repro`` stays the reference; this package mirrors its
layout (``repro_torch/core/graph/executor.py`` <-> ``repro/core/graph/
executor.py`` and so on) and imports nothing of it.  Every Pallas kernel on
the ported path is a hand-written CUDA kernel under ``kernels/csrc/``, built
with nvcc at first use and bound through ctypes (``kernels/_build.py``).

Entry points run on ``cuda`` unless the caller asks for ``cpu``; the device
of the tensors picks the route: a CPU tensor takes a kernel's plain PyTorch
version, a CUDA tensor launches the kernel (or raises).
"""

__all__ = ["convert"]
