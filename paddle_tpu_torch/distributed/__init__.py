"""`paddle.distributed` (counterpart of `paddle_tpu/distributed`), one
process a rank over `torch.distributed`: the collectives (`collective`,
`stream`), the environment (`env`: `init_parallel_env` over NCCL or
gloo), `spawn`, the rendezvous store (`store.TCPStore`), the mesh
(`mesh`: a DeviceMesh with an axis's group per dimension,
`CommunicateTopology`, `HybridCommunicateGroup`), `DataParallel` with
its gradient buckets, and `fleet` (`fleet.init` / `distributed_model` /
`distributed_optimizer`, the tensor-parallel layers, sequence parallelism,
`TensorParallel`, `HybridParallelOptimizer`, ZeRO's
`DygraphShardingOptimizer` and `group_sharded_parallel`, recompute), the
auto-parallel API over DTensor (`auto_parallel`: `ProcessMesh`,
`shard_tensor`, `reshard`, ...), the spec annotations of `sharding_utils`
and `split`, the pipeline schedules (`pipeline`: `spmd_pipeline` and
the per-rank programs `build_train_step` runs at pp > 1), and sharded
checkpoints (`checkpoint`: `save_state_dict`, `load_state_dict`,
`CheckpointManager`)."""
import torch

from . import auto_parallel  # noqa: F401
from . import checkpoint  # noqa: F401
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
from .pipeline import spmd_pipeline  # noqa: F401
from .spawn import spawn  # noqa: F401
from . import sharding_utils  # noqa: F401
from .auto_parallel import (  # noqa: F401
    Partial,
    ProcessMesh,
    Replicate,
    Shard,
    dtensor_from_fn,
    reshard,
    shard_layer,
    shard_op,
)
from .sharding_utils import get_param_spec, mark_sharding  # noqa: F401
from .sharding_utils import shard_tensor as _shard_tensor_spec


def shard_tensor(x, *args, **kwargs):
    """`paddle.distributed.shard_tensor(x, mesh, placements)` (a
    `ProcessMesh`: `auto_parallel.shard_tensor`), or the spec form
    `shard_tensor(x, 'dp', None, ...)` over the global mesh
    (`sharding_utils.shard_tensor`)."""
    from .auto_parallel import shard_tensor as _ap_shard

    if (args and isinstance(args[0], ProcessMesh)) or "mesh" in kwargs:
        return _ap_shard(x, *args, **kwargs)
    return _shard_tensor_spec(x, *args, **kwargs)


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


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """`paddle.distributed.split`: build a tensor-parallel linear or
    embedding over the "tp" axis and return its output for `x` (a new
    layer each call, as the reference builds it inline). `operation`
    "linear" with `size` (in, out): `axis` 1 a column-parallel linear
    (`gather_out` gathers its output), 0 a row-parallel one taking the
    whole `x`; "embedding" with `size` (vocab, dim): a vocab-parallel
    embedding. `num_partitions` must be 1 or the "tp" degree. The weight
    is this rank's slice of one full Xavier-normal draw (`_split_init`),
    the bias 0;
    `bias_attr` False leaves the bias out."""
    from . import mesh as _mesh_mod
    from .fleet.layers.mpu import mp_layers as _mp

    if axis not in (0, 1):
        raise ValueError(f"split: axis must be 0 or 1, got {axis}")
    tp = _mesh_mod.axis_size("tp")
    if num_partitions not in (1, tp):
        raise ValueError(
            f"split: num_partitions ({num_partitions}) must equal the tp "
            f"mesh size ({tp}) — the reference asserts the same")
    dtype = x.dtype if x.is_floating_point() else torch.float32
    kw = dict(dtype=dtype, device=x.device)
    if operation == "linear":
        in_f, out_f = size
        if axis == 1:
            layer = _mp.ColumnParallelLinear(
                in_f, out_f, weight_attr=weight_attr,
                has_bias=bias_attr is not False, gather_output=gather_out,
                **kw)
        else:
            layer = _mp.RowParallelLinear(
                in_f, out_f, weight_attr=weight_attr,
                has_bias=bias_attr is not False, input_is_parallel=False,
                **kw)
        _split_init(layer, (in_f, out_f), axis)
        return layer(x)
    if operation == "embedding":
        vocab, dim = size
        layer = _mp.VocabParallelEmbedding(vocab, dim,
                                           weight_attr=weight_attr, **kw)
        _split_init(layer, (vocab, dim), 0)
        return layer(x)
    raise ValueError(f"unsupported split operation {operation!r}")


@torch.no_grad()
def _split_init(layer, full_shape, axis):
    """`split`'s layer: its weight this rank's slice (along `axis`, the
    tensor-parallel split) of one draw of `full_shape` from the reference's
    default initialiser (Xavier normal) on the global stream (the same on
    every rank seeded alike), its bias 0."""
    from ..framework import random as _random
    from ..nn.layers import xavier_normal

    w = layer.weight
    full = xavier_normal(full_shape, _random._current(), torch.float32,
                         "cpu")
    n = w.shape[axis]
    r = layer.rank if n != full_shape[axis] else 0
    w.copy_(full.narrow(axis, r * n, n))
    if getattr(layer, "bias", None) is not None:
        layer.bias.zero_()
