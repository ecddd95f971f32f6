"""meta_parallel (counterpart of
`paddle_tpu/distributed/fleet/meta_parallel/`): the tensor-parallel
layers, `TensorParallel`, `HybridParallelOptimizer` and ZeRO's
`DygraphShardingOptimizer` (`sharding/`). Pipeline parallelism is a later
bullet of ROADMAP Queue 1 item 4: its classes raise."""
from ..layers.mpu import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
    get_rng_state_tracker,
)
from .hybrid_optimizer import (  # noqa: F401
    HybridParallelClipGrad,
    HybridParallelOptimizer,
)
from .sharding.sharding_optimizer import DygraphShardingOptimizer  # noqa: F401,E501
from .tensor_parallel import TensorParallel  # noqa: F401


class _NotPorted:
    _what = ""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported yet ({self._what}, "
            "ROADMAP Queue 1 item 4)")


class PipelineParallel(_NotPorted):
    _what = "pipeline parallelism: pipeline.py, meta_parallel/"\
        "pipeline_parallel.py"


class PipelineLayer(_NotPorted):
    _what = "pipeline parallelism: meta_parallel/pp_layers.py"
