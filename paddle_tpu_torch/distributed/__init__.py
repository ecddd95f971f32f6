"""`paddle.distributed` (counterpart of `paddle_tpu/distributed`), one
process a rank over `torch.distributed`: the collectives (`collective`,
`stream`), the environment (`env`: `init_parallel_env` over NCCL or
gloo), `spawn`, the rendezvous store (`store.TCPStore`), the mesh
(`mesh`: a DeviceMesh with an axis's group per dimension,
`CommunicateTopology`, `HybridCommunicateGroup`), `DataParallel` with
its gradient buckets, and `fleet` (`fleet.init` / `distributed_model` /
`distributed_optimizer`, the tensor-parallel layers, sequence parallelism,
`TensorParallel`, `HybridParallelOptimizer`, recompute)."""
from . import collective  # noqa: F401
from . import env  # noqa: F401
from . import fleet  # noqa: F401
from . import mesh  # noqa: F401
from . import stream  # noqa: F401
from .collective import (  # noqa: F401
    P2POp,
    ReduceOp,
    all_gather,
    all_gather_object,
    all_reduce,
    alltoall,
    alltoall_single,
    barrier,
    batch_isend_irecv,
    broadcast,
    broadcast_object_list,
    destroy_process_group,
    gather,
    get_backend,
    get_group,
    gloo_barrier,
    irecv,
    is_available,
    isend,
    new_group,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    scatter_object_list,
    send,
    wait,
)
from .env import get_rank, get_world_size, init_parallel_env  # noqa: F401
from .mesh import (  # noqa: F401
    build_mesh,
    get_mesh,
    init_mesh,
    named_sharding,
    set_mesh,
)
from .parallel import DataParallel  # noqa: F401
from .spawn import spawn  # noqa: F401


def is_initialized():
    return env.is_initialized()


class ParallelEnv:
    @property
    def rank(self):
        return env.get_rank()

    @property
    def world_size(self):
        return env.get_world_size()

    @property
    def device_id(self):
        d = env.device()
        return d.index if d is not None and d.index is not None else 0

    @property
    def local_rank(self):
        return env.get_rank()

    @property
    def nranks(self):
        return env.get_world_size()
