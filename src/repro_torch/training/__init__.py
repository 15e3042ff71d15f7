"""Training (port): AdamW, the ADMM-aware train step, checkpoints and
fault-tolerance plumbing.  The mesh modules of the JAX package
(``compression``, ``collective_matmul``, ``pipeline_parallel``) and
``zero1_pspecs`` wait for ROADMAP A9."""

from .checkpoint import CheckpointManager, restore, save
from .fault_tolerance import Heartbeat, PreemptionHandler, StragglerMonitor, retry
from .optimizer import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from .train_loop import TrainState, init_train_state, make_train_step

__all__ = [
    "CheckpointManager", "restore", "save", "Heartbeat", "PreemptionHandler",
    "StragglerMonitor", "retry", "AdamWConfig", "adamw_init", "adamw_update",
    "cosine_schedule", "TrainState", "init_train_state", "make_train_step",
]
