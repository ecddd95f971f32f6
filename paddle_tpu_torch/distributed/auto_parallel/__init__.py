"""The auto-parallel API (counterpart of
`paddle_tpu/distributed/auto_parallel/`) over `torch.distributed.tensor`:
`ProcessMesh` builds a `DeviceMesh`, the placements are torch's, and
`shard_tensor` / `reshard` return DTensors."""
from .api import (  # noqa: F401
    DistAttr,
    Partial,
    Placement,
    ProcessMesh,
    Replicate,
    Shard,
    dtensor_from_fn,
    get_mesh,
    reshard,
    set_mesh,
    shard_layer,
    shard_op,
    shard_tensor,
)
