"""Structured pruning (port): the structure sets, their projections, mask
algebra, ADMM and the sparsity schedules -- the JAX package's exports."""

from .structures import (
    BankBalanced,
    Block,
    CANONICAL_PATTERNS,
    Channel,
    NM,
    PatternKernel,
    Row,
    Structure,
    Unstructured,
    Column,
    structure_from_spec,
)
from .projections import mask_for, project, topk_mask
from .masks import (
    apply_masks,
    combine_masks,
    count_params,
    mask_gradients,
    sparsity,
    tree_sparsity_report,
)
from .admm import (
    AdmmConfig,
    AdmmState,
    PrunePlan,
    admm_init,
    admm_penalty,
    admm_update,
    convergence_metrics,
    hard_prune,
)
from .schedule import (
    SensitivityResult,
    assign_sparsities,
    polynomial_schedule,
    sensitivity_scan,
)

__all__ = [
    "BankBalanced", "Block", "CANONICAL_PATTERNS", "Channel", "NM", "PatternKernel", "Row",
    "Structure", "Unstructured", "Column", "structure_from_spec",
    "mask_for", "project", "topk_mask",
    "apply_masks", "combine_masks", "count_params", "mask_gradients", "sparsity",
    "tree_sparsity_report",
    "AdmmConfig", "AdmmState", "PrunePlan", "admm_init", "admm_penalty", "admm_update",
    "convergence_metrics", "hard_prune",
    "SensitivityResult", "assign_sparsities", "polynomial_schedule", "sensitivity_scan",
]
