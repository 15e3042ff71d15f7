"""The port's kernels: hand-written CUDA kernels (``csrc/``), each with its
wrapper, plain PyTorch version and launch counter in the module of the same
name (``conv2d``, ``dense_matmul``, ``fused_elementwise``), and the public
``ops`` layer the executor calls."""

from . import ops, ref

__all__ = ["ops", "ref"]
