from .recompute import recompute, recompute_sequential  # noqa: F401
from .sequence_parallel_utils import (  # noqa: F401
    AllGatherOp,
    ColumnSequenceParallelLinear,
    GatherOp,
    ReduceScatterOp,
    RowSequenceParallelLinear,
    ScatterOp,
    mark_as_sequence_parallel_parameter,
    register_sequence_parallel_allreduce_hooks,
)
