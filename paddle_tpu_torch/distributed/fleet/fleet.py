"""The fleet singleton (counterpart of
`paddle_tpu/distributed/fleet/fleet.py`).

`fleet.init(strategy=...)` starts the process group
(`init_parallel_env`; a caller that wants CPU ranks calls
`init_parallel_env(device="cpu")` first) and builds the global mesh from
`strategy.hybrid_configs` (`dp_degree`, `mp_degree`, `pp_degree`,
`sharding_degree`, `sep_degree`: an axis of degree 1 is dropped).
`distributed_model` returns `PipelineParallel` at pp_degree > 1 (over a
`PipelineLayer`, or over a LLaMA / GPT built under the mesh, which holds
its stage: Paddle has users hand a `PipelineLayer`, the reference its
models; both are taken), `TensorParallel` at mp_degree > 1,
`DataParallel` at dp_degree > 1 alone, and the model itself otherwise (at
sharding_degree > 1 the model is left to the optimizer's stage, as in the
reference); `distributed_optimizer` returns `DygraphShardingOptimizer`
(ZeRO stage 1 over "sharding") at sharding_degree > 1, else
`HybridParallelOptimizer` (over the rank's stage at pp > 1).
`strategy.pipeline_configs` (`accumulate_steps`, `micro_batch_size`,
`schedule_mode`) is read by `PipelineParallel`; `sharding_configs` is
read by nothing, as in the reference (its degree is
`hybrid_configs["sharding_degree"]`, its stage the optimizer's). `save`
and `load_model` write and read one sharded checkpoint
(`distributed/checkpoint.py`). The worker and role API is the reference's;
the parameter-server half raises.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import collective as _collective
from .. import env as _env
from .. import mesh as _mesh
from ..parallel import DataParallel
from .base.distributed_strategy import DistributedStrategy
from .base.topology import CommunicateTopology, HybridCommunicateGroup


class Fleet:
    def __init__(self):
        self._strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._is_initialized = False
        self._model = None

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO"):
        self._strategy = strategy or DistributedStrategy()
        hc = self._strategy.hybrid_configs
        dp = int(hc.get("dp_degree", 1))
        tp = int(hc.get("mp_degree", 1))
        pp = int(hc.get("pp_degree", 1))
        sharding = int(hc.get("sharding_degree", 1))
        sep = int(hc.get("sep_degree", 1))
        _env.init_parallel_env()
        _mesh.init_mesh(dp=dp, tp=tp, pp=pp, sharding=sharding, sep=sep)
        topo = CommunicateTopology(
            ("data", "pipe", "sharding", "model"), (dp, pp, sharding, tp))
        self._hcg = HybridCommunicateGroup(topo, _mesh.get_mesh())
        self._is_initialized = True
        return self

    @property
    def worker_index(self):
        return _env.get_rank()

    def worker_num(self):
        return _env.get_world_size()

    def is_first_worker(self):
        return _env.get_rank() == 0

    def barrier_worker(self):
        _collective.barrier()

    def get_hybrid_communicate_group(self):
        return self._hcg

    def distributed_model(self, model):
        self._model = model
        strategy = self._strategy or DistributedStrategy()
        hc = strategy.hybrid_configs
        if int(hc.get("pp_degree", 1)) > 1:
            from .meta_parallel.pipeline_parallel import PipelineParallel

            return PipelineParallel(model, self._hcg, strategy)
        if int(hc.get("mp_degree", 1)) > 1:
            from .meta_parallel.tensor_parallel import TensorParallel

            return TensorParallel(model, self._hcg, strategy)
        if int(hc.get("dp_degree", 1)) > 1:
            return DataParallel(model)
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        strat = strategy or self._strategy or DistributedStrategy()
        if int(strat.hybrid_configs.get("sharding_degree", 1)) > 1:
            from .meta_parallel.sharding.sharding_optimizer import \
                DygraphShardingOptimizer

            return DygraphShardingOptimizer(optimizer, self._hcg)
        from .meta_parallel.hybrid_optimizer import HybridParallelOptimizer

        return HybridParallelOptimizer(optimizer, self._hcg, strat)

    def save(self, dirname, model=None, optimizer=None, **configs):
        """`model` (default: the one `distributed_model` wrapped) and
        `optimizer` as one checkpoint at `dirname`, every rank writing
        what it holds (`distributed.checkpoint.save_model_state`)."""
        from .. import checkpoint as _ckpt

        model = model if model is not None else self._model
        if model is None:
            raise ValueError("fleet.save needs a model (none wrapped yet)")
        _ckpt.save_model_state(getattr(model, "_layers", model), optimizer,
                               dirname, **configs)

    def load_model(self, path, model=None, optimizer=None, **configs):
        """Read a `save` checkpoint into `model` and `optimizer` at their
        own layout (`distributed.checkpoint.load_model_state`)."""
        from .. import checkpoint as _ckpt

        model = model if model is not None else self._model
        if model is None:
            raise ValueError("fleet.load_model needs a model")
        return _ckpt.load_model_state(getattr(model, "_layers", model),
                                      optimizer, path, **configs)


fleet = Fleet()
init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer


def get_hybrid_communicate_group():
    return fleet.get_hybrid_communicate_group()


# the worker and role API; the parameter-server half raises


def worker_index():
    """This worker's rank."""
    return _env.get_rank()


def worker_num():
    """The number of collective workers."""
    return _env.get_world_size()


def is_first_worker():
    return _env.get_rank() == 0


def is_worker():
    """Collective mode: every process is a worker."""
    return True


def is_server():
    """Collective mode: there are no parameter servers."""
    return False


def worker_endpoints(to_string=False):
    eps = [e for e in os.environ.get(
        "PADDLE_TRAINER_ENDPOINTS", "").split(",") if e]
    if not eps:
        eps = ["127.0.0.1:0"] * _env.get_world_size()
    return ",".join(eps) if to_string else eps


def barrier_worker():
    _collective.barrier()


def init_worker(scopes=None):
    """The parameter-server worker's start: nothing to do in collective
    mode (kept for scripts)."""


def stop_worker():
    """The parameter-server worker's stop: nothing to do in collective
    mode."""


def init_server(*args, **kwargs):
    raise NotImplementedError(
        "parameter-server mode is not ported (the reference does not have "
        "it either); use collective mode")


def run_server():
    raise NotImplementedError(
        "parameter-server mode is not ported (the reference does not have "
        "it either); use collective mode")


class UserDefinedRoleMaker:
    """Explicit role assignment (pure arithmetic, no processes)."""

    def __init__(self, current_id=0, role=None, worker_num=1,
                 server_endpoints=None, is_collective=True, **kwargs):
        self._current_id = int(current_id)
        self._worker_num = int(worker_num)
        self._is_collective = is_collective

    def worker_index(self):
        return self._current_id

    def worker_num(self):
        return self._worker_num

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def is_first_worker(self):
        return self._current_id == 0


class PaddleCloudRoleMaker(UserDefinedRoleMaker):
    """The role from the launch contract (`PADDLE_TRAINER_ID`,
    `PADDLE_TRAINERS_NUM`)."""

    def __init__(self, is_collective=True, **kwargs):
        super().__init__(
            current_id=int(os.environ.get("PADDLE_TRAINER_ID", "0")),
            worker_num=int(os.environ.get("PADDLE_TRAINERS_NUM", "1")),
            is_collective=is_collective)


class UtilBase:
    """`fleet.util`: small cross-worker helpers."""

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        """`input` (array-like) reduced over every worker, as numpy (on
        the rank's device in between)."""
        t = torch.from_numpy(np.array(input))
        dev = _env.device()
        if dev is not None:
            t = t.to(dev)
        op = {"sum": _collective.ReduceOp.SUM,
              "max": _collective.ReduceOp.MAX,
              "min": _collective.ReduceOp.MIN}[mode]
        _collective.all_reduce(t, op=op)
        return t.cpu().numpy()

    def barrier(self, comm_world="worker"):
        _collective.barrier()

    def get_file_shard(self, files):
        """`files` split contiguously over the workers, the earlier ones
        taking the remainder."""
        n = _env.get_world_size()
        r = _env.get_rank()
        per, rem = divmod(len(files), n)
        start = r * per + min(r, rem)
        return files[start:start + per + (1 if r < rem else 0)]


util = UtilBase()
