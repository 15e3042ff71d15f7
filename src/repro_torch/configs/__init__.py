"""Architecture configs of the port (copies of ``repro.configs``' data)."""

from .base import ArchConfig, MoEConfig, PruneConfig, RecurrentConfig, SHAPES, SSMConfig, ShapeConfig
from .registry import ARCH_IDS, get_config, shape_cells, smoke_config

__all__ = [
    "ARCH_IDS",
    "ArchConfig",
    "MoEConfig",
    "PruneConfig",
    "RecurrentConfig",
    "SHAPES",
    "SSMConfig",
    "ShapeConfig",
    "get_config",
    "shape_cells",
    "smoke_config",
]
