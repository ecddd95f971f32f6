"""`paddle.distributed.fleet` (counterpart of
`paddle_tpu/distributed/fleet/`): `fleet.init` / `distributed_model` /
`distributed_optimizer` and `DistributedStrategy` over the global mesh,
the tensor-parallel layers (`layers.mpu`), sequence parallelism and
recompute (`utils`), and `meta_parallel`."""
from .base.distributed_strategy import DistributedStrategy  # noqa: F401
from .base.topology import CommunicateTopology, HybridCommunicateGroup  # noqa: F401
from .fleet import (  # noqa: F401
    Fleet,
    PaddleCloudRoleMaker,
    UserDefinedRoleMaker,
    UtilBase,
    barrier_worker,
    distributed_model,
    distributed_optimizer,
    fleet,
    get_hybrid_communicate_group,
    init,
    init_server,
    init_worker,
    is_first_worker,
    is_server,
    is_worker,
    run_server,
    stop_worker,
    util,
    worker_endpoints,
    worker_index,
    worker_num,
)
from . import layers  # noqa: F401
from . import utils  # noqa: F401
from . import meta_parallel  # noqa: F401
from .utils import recompute  # noqa: F401
