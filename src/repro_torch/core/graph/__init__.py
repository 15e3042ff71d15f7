from .ir import Graph, GraphBuilder, Node
from .executor import (
    BACKENDS,
    BatchedPlan,
    ExecutionPlan,
    compile_plan,
    handlers_for,
    register_op,
    registered_ops,
)
from .lowering import lower
from .pass_manager import (
    DEFAULT_PIPELINE,
    GraphPass,
    InvariantViolation,
    PassContext,
    PassManager,
    PassStats,
    available_passes,
    get_pass,
    register_pass,
)
from .passes import (
    cse,
    dce,
    fold_gathers,
    fold_norm,
    fuse_activation,
    fuse_elementwise,
    fuse_epilogue,
    optimize,
    quantize,
    substitute_sparse,
)
