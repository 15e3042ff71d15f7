"""Quantization subsystem (a port of ``repro.quant``): INT8 storage and
calibration.

* :mod:`repro_torch.quant.qtensor` -- symmetric per-tensor/per-channel int8
  :class:`QTensor` with absmax quantize/dequantize helpers;
* :mod:`repro_torch.quant.calibrate` -- :func:`calibrate_plan` runs sample
  batches through an ExecutionPlan and records per-value activation ranges
  (:class:`CalibrationTable`, JSON in the JAX package's schema);
* the ``quantize`` pass lives in :mod:`repro_torch.core.graph.passes`; the
  INT8 CUDA kernels in :mod:`repro_torch.kernels.quant_matmul` and
  :mod:`repro_torch.kernels.conv2d`; the ``qlinear``/``qconv2d`` handlers and
  the ``quant`` backend in :mod:`repro_torch.core.graph.executor`.
"""

from .calibrate import CalibrationTable, calibrate_plan
from .qtensor import QMAX, QTensor, fake_quant, quantize_array

__all__ = [
    "QTensor",
    "QMAX",
    "quantize_array",
    "fake_quant",
    "CalibrationTable",
    "calibrate_plan",
]
