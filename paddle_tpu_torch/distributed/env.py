"""The process environment (counterpart of `paddle_tpu/distributed/env.py`).

One process a rank, as Paddle runs: `init_parallel_env` reads the launch
contract (`PADDLE_TRAINER_ID`, `PADDLE_TRAINERS_NUM`, `PADDLE_MASTER` or
`MASTER_ADDR` / `MASTER_PORT`, `PADDLE_LOCAL_RANK`, `PADDLE_LOCAL_SIZE`,
as `spawn` sets them) and starts `torch.distributed`'s default group over
`tcp://` at the master. The reference runs one process over a device mesh
instead (ROADMAP: deliberate differences).

The rank's device is `framework.device.resolve_device(device)`: by default
the card `PADDLE_LOCAL_RANK % device_count` (raising without CUDA), or the
CPU when the caller asks for it. The backend is NCCL for a CUDA rank and
gloo for a CPU rank. A caller may name the backend instead, through
Paddle's `PADDLE_DISTRI_BACKEND` environment variable: "gloo" on CUDA
ranks is the one way to run collectives on CUDA tensors over gloo (the
port's counterpart of choosing a platform), e.g. two ranks on one card,
which NCCL refuses. Nothing falls back from one backend to the other:
NCCL with more ranks on a host than cards raises, naming the reason.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..framework.device import resolve_device

_initialized = False
_device = None


def _master():
    master = os.environ.get("PADDLE_MASTER")
    if master:
        host, _, port = master.rpartition(":")
        return host, port
    return (os.environ.get("MASTER_ADDR", "127.0.0.1"),
            os.environ.get("MASTER_PORT", "8476"))


def init_parallel_env(device=None, timeout=None):
    """`paddle.distributed.init_parallel_env`: start the default process
    group of PADDLE_TRAINERS_NUM ranks (1 when unset) for this rank
    (PADDLE_TRAINER_ID), once; later calls return. `device` (port-only)
    picks the rank's device as above; `timeout` (seconds, default
    torch.distributed's) bounds the rendezvous and each collective."""
    global _initialized, _device
    if _initialized:
        return
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    local_rank = int(os.environ.get("PADDLE_LOCAL_RANK", str(rank)))
    local_size = int(os.environ.get("PADDLE_LOCAL_SIZE", str(world)))
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    dev = resolve_device(device)
    backend = os.environ.get("PADDLE_DISTRI_BACKEND", "").lower() or (
        "nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"PADDLE_DISTRI_BACKEND={backend!r}: the port runs "
                         "'nccl' or 'gloo'")
    if backend == "nccl":
        if dev.type != "cuda":
            raise RuntimeError("NCCL runs CUDA ranks only; this rank is on "
                               f"{dev}")
        if local_size > torch.cuda.device_count():
            raise RuntimeError(
                f"NCCL refuses two ranks on one card: {local_size} ranks on "
                f"this host, {torch.cuda.device_count()} card(s). Give each "
                "rank a card of its own, or name the gloo backend "
                "(PADDLE_DISTRI_BACKEND=gloo) to run CUDA tensors over gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    host, port = _master()
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=float(timeout))}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                            world_size=world, rank=rank, **kw)
    _device = dev
    _initialized = True


def device():
    """The device `init_parallel_env` gave this rank (None before)."""
    return _device


def get_rank():
    env = os.environ.get("PADDLE_TRAINER_ID")
    if env is not None:
        return int(env)
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size():
    env = os.environ.get("PADDLE_TRAINERS_NUM")
    if env is not None:
        return int(env)
    # the data-parallel size when a mesh is live, as the reference's
    from . import mesh as _mesh

    m = _mesh.get_mesh(optional=True)
    if m is not None and "dp" in m.mesh_dim_names:
        return int(m["dp"].size())
    return dist.get_world_size() if dist.is_initialized() else 1


def is_initialized():
    return _initialized


def _reset():
    """Forget the default group (`destroy_process_group`)."""
    global _initialized, _device
    _initialized = False
    _device = None
