from .mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from .random import RNGStatesTracker, get_rng_state_tracker  # noqa: F401
