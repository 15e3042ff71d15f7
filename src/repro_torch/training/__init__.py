"""Training (port): AdamW (with ZeRO-1 moment specs), the ADMM-aware train
step, mesh-elastic checkpoints, fault-tolerance plumbing, and the mesh
modules on ``torch.distributed``: int8 / top-k gradient compression
(``compression``), the overlapped ring matmuls (``collective_matmul``) and
GPipe (``pipeline_parallel``)."""

from .checkpoint import CheckpointManager, restore, save
from .fault_tolerance import Heartbeat, PreemptionHandler, StragglerMonitor, retry
from .optimizer import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from .train_loop import TrainState, init_train_state, make_train_step

__all__ = [
    "CheckpointManager", "restore", "save", "Heartbeat", "PreemptionHandler",
    "StragglerMonitor", "retry", "AdamWConfig", "adamw_init", "adamw_update",
    "cosine_schedule", "TrainState", "init_train_state", "make_train_step",
]
