"""Data pipelines of the port (copies of the JAX package's numpy code)."""

from .pipeline import PipelineState, SyntheticPipeline

__all__ = ["PipelineState", "SyntheticPipeline"]
