"""ZeRO sharding (counterpart of
`paddle_tpu/distributed/fleet/meta_parallel/sharding/`)."""
from .sharding_optimizer import (  # noqa: F401
    DygraphShardingOptimizer,
    group_sharded_parallel,
    shard_spec_for,
)
