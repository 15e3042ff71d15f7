"""Quantized-tensor core: symmetric INT8 storage with f32 scales (a port of
``repro.quant.qtensor``).

A :class:`QTensor` is the storage format the ``quantize`` compiler pass
produces: an int8 ``values`` tensor plus a float32 ``scale`` -- a scalar for
per-tensor quantization, or a vector along ``axis`` for per-channel (one
scale per output channel).

Symmetric absmax quantization::

    scale  = absmax(x) / 127          (per tensor or per channel)
    q      = clip(round(x / scale), -127, 127)  as int8
    dequant(q) = q * scale

The value ``-128`` is never produced (symmetric range), so ``-q`` is always
representable.  ``round`` is half-to-even (``torch.round``, as
``jnp.round``).

Bit-equality with the JAX package on every device: each scale is a float32
tensor on the data's own device, of shape ``(1,)`` for a scalar.  PyTorch's
CUDA division by a CPU scalar (a Python float or a 0-dim CPU tensor)
multiplies by the reciprocal instead, which rounds differently; a tensor on
the device takes the true division.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["QTensor", "quantize_array", "fake_quant", "scale_tensor", "QMAX"]

#: symmetric int8 range: [-127, 127] (never -128)
QMAX = 127.0

#: scales below this are clamped so all-zero channels dequantize to zeros
#: instead of NaNs
_EPS = 1e-12

ScaleLike = Union[float, torch.Tensor]


def _absmax(x: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    """absmax over all dims (per-tensor) or all-but-``axis`` (per-channel)."""
    if axis is None:
        return x.abs().max()
    keep = axis % x.dim()
    return x.abs().amax(dim=tuple(i for i in range(x.dim()) if i != keep))


def scale_tensor(
    scale: ScaleLike, x: torch.Tensor, axis: Optional[int] = None
) -> torch.Tensor:
    """``scale`` as a float32 tensor on ``x``'s device, shaped to broadcast
    against ``x`` (along ``axis`` for a per-channel vector, ``(1,)`` for a
    scalar): a Python float rounds to f32 as ``jnp.float32`` does, and
    dividing by the result is a true division on every device.  A Python
    scalar is filled on the device (``torch.full``): copying a host tensor
    there would be a blocking copy, a host sync at every W8A8 step."""
    if isinstance(scale, (float, int, np.floating, np.integer)):
        return torch.full((1,), float(scale), dtype=torch.float32, device=x.device)
    s = torch.as_tensor(scale, dtype=torch.float32).to(x.device)
    if axis is not None and s.dim() == 1:
        shape = [1] * x.dim()
        shape[axis % x.dim()] = -1
        return s.reshape(shape)
    return s.reshape(1) if s.dim() == 0 else s


def quantize_array(
    x: torch.Tensor, scale: ScaleLike, axis: Optional[int] = None
) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8; ``scale`` broadcasts
    along ``axis`` (or is a scalar)."""
    q = torch.round(x.float() / scale_tensor(scale, x, axis))
    return q.clamp_(-QMAX, QMAX).to(torch.int8)


def fake_quant(x: torch.Tensor, scale: ScaleLike, axis: Optional[int] = None) -> torch.Tensor:
    """Quantize-then-dequantize in f32: the reference-side simulation of the
    kernel's int8 activation path (the same rounding and clipping)."""
    return quantize_array(x, scale, axis).float() * scale_tensor(scale, x, axis)


@dataclasses.dataclass(frozen=True)
class QTensor:
    """Symmetric int8 tensor: ``dequantize() == values * scale``.

    ``axis=None`` -> per-tensor (``scale`` 0-dim); ``axis=i`` -> per-channel
    along dim ``i`` (``scale`` a vector of ``shape[i]``).
    """

    values: torch.Tensor  # int8
    scale: torch.Tensor  # f32, () or [shape[axis]]
    axis: Optional[int] = None

    # -- construction -------------------------------------------------------- #
    @classmethod
    def from_float(cls, x: torch.Tensor, axis: Optional[int] = None) -> "QTensor":
        """Absmax-calibrated symmetric quantization of ``x``."""
        amax = _absmax(x, axis)
        scale = (amax.clamp_min(_EPS).float() / scale_tensor(QMAX, amax)).reshape(amax.shape)
        return cls(values=quantize_array(x, scale, axis), scale=scale, axis=axis)

    # -- views --------------------------------------------------------------- #
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.values.shape)

    @property
    def nbytes(self) -> int:
        """Stored bytes: int8 payload + f32 scales."""
        return int(self.values.numel()) + int(self.scale.numel()) * 4

    def compression_ratio(self, orig_dtype: torch.dtype = torch.float32) -> float:
        itemsize = torch.empty((), dtype=orig_dtype).element_size()
        return int(self.values.numel()) * itemsize / max(self.nbytes, 1)

    def scale_broadcast(self) -> torch.Tensor:
        """``scale`` shaped to broadcast against ``values``."""
        if self.axis is None or self.scale.dim() == 0:
            return self.scale
        shape = [1] * self.values.dim()
        shape[self.axis % self.values.dim()] = -1
        return self.scale.reshape(shape)

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (self.values.float() * self.scale_broadcast()).to(dtype)

    def max_abs_error(self, x: torch.Tensor) -> float:
        """Worst-case reconstruction error against the original ``x``."""
        return float((self.dequantize() - x.float()).abs().max())
