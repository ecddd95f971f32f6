"""meta_parallel (counterpart of
`paddle_tpu/distributed/fleet/meta_parallel/`): the tensor-parallel
layers, `TensorParallel`, the pipeline's `PipelineParallel`, `LayerDesc`,
`SharedLayerDesc` and `PipelineLayer` (with the point-to-point transfers
of `pp_utils`), `HybridParallelOptimizer` and ZeRO's
`DygraphShardingOptimizer` (`sharding/`)."""
from ..layers.mpu import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
    get_rng_state_tracker,
)
from . import pp_utils  # noqa: F401
from .hybrid_optimizer import (  # noqa: F401
    HybridParallelClipGrad,
    HybridParallelOptimizer,
)
from .pipeline_parallel import PipelineParallel  # noqa: F401
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc  # noqa: F401
from .sharding.sharding_optimizer import DygraphShardingOptimizer  # noqa: F401,E501
from .tensor_parallel import TensorParallel  # noqa: F401
