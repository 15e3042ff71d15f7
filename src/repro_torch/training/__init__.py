"""Training (port): AdamW (with ZeRO-1 moment specs), the ADMM-aware train
step, mesh-elastic checkpoints, fault-tolerance plumbing, and the mesh
modules on ``torch.distributed``: int8 / top-k gradient compression
(``compression``), the overlapped ring matmuls (``collective_matmul``) and
GPipe (``pipeline_parallel``).

The mesh modules' exports load on first use (a module ``__getattr__``), so
importing the package pulls in no collective code."""

import importlib

from .checkpoint import CheckpointManager, restore, save
from .fault_tolerance import Heartbeat, PreemptionHandler, StragglerMonitor, retry
from .optimizer import AdamWConfig, adamw_init, adamw_update, cosine_schedule, zero1_pspecs
from .train_loop import TrainState, init_train_state, make_train_step

#: lazily loaded export -> its module
_LAZY = {
    "CompressionConfig": "compression",
    "make_compressed_allreduce": "compression",
    "ag_matmul": "collective_matmul",
    "make_overlapped_tp_matmuls": "collective_matmul",
    "rs_matmul": "collective_matmul",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CheckpointManager", "restore", "save", "Heartbeat", "PreemptionHandler",
    "StragglerMonitor", "retry", "AdamWConfig", "adamw_init", "adamw_update",
    "cosine_schedule", "zero1_pspecs", "TrainState", "init_train_state", "make_train_step",
    *_LAZY,
]
