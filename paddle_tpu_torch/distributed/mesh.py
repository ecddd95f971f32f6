"""The device mesh (counterpart of `paddle_tpu/distributed/mesh.py`).

`build_mesh` lays the ranks of the default process group out as a
`torch.distributed.device_mesh.DeviceMesh` with named dimensions, so each
axis has its own process group (`mesh["dp"].get_group()`); the collectives
name an axis as their `group`. The axes keep the reference's `AXIS_ORDER`
(outermost first) and its rule: an axis of degree 1 is dropped, and `dp`
stays when every axis is dropped. `CommunicateTopology` and
`HybridCommunicateGroup` are the reference's rank arithmetic.
`named_sharding` waits for the port's DTensor layer and raises.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

_lock = threading.Lock()
_global_mesh: Optional[DeviceMesh] = None

# outermost (slowest-varying) -> innermost (fastest)
AXIS_ORDER = ("pp", "dp", "sharding", "sep", "ep", "cp", "tp", "sp")


def build_mesh(dp: int = 1, tp: int = 1, pp: int = 1, sp: int = 1,
               sharding: int = 1, ep: int = 1, cp: int = 1, sep: int = 1,
               devices=None) -> DeviceMesh:
    """The hybrid mesh over the ranks of the default group (0..n-1 in
    row-major order, or the first n of `devices`, a sequence of global
    ranks). Needs `init_parallel_env` first; every rank of the default
    group must call it, as it makes each axis's group."""
    sizes: Dict[str, int] = {
        "pp": pp, "dp": dp, "sharding": sharding, "sep": sep, "ep": ep,
        "cp": cp, "tp": tp, "sp": sp,
    }
    axes = [a for a in AXIS_ORDER if sizes[a] > 1] or ["dp"]
    shape = [sizes[a] for a in axes]
    if not dist.is_initialized():
        raise RuntimeError("build_mesh: no process group; call "
                           "distributed.init_parallel_env first")
    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    need = int(np.prod(shape))
    if need > len(ranks):
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {need} "
                         f"devices, have {len(ranks)}")
    from .env import device as _device

    dev = _device()
    dev_type = dev.type if dev is not None else "cpu"
    grid = torch.tensor(ranks[:need], dtype=torch.int).reshape(shape)
    return DeviceMesh(dev_type, grid, mesh_dim_names=tuple(axes))


def set_mesh(mesh: Optional[DeviceMesh]):
    global _global_mesh
    with _lock:
        _global_mesh = mesh
    return mesh


def get_mesh(optional: bool = False) -> Optional[DeviceMesh]:
    if _global_mesh is None and not optional:
        raise RuntimeError(
            "no global mesh: call fleet.init / distributed.init_mesh first")
    return _global_mesh


def init_mesh(**degrees) -> DeviceMesh:
    return set_mesh(build_mesh(**degrees))


def axis_size(name: str) -> int:
    m = get_mesh(optional=True)
    if m is None or name not in (m.mesh_dim_names or ()):
        return 1
    return int(m[name].size())


def named_sharding(*spec):
    raise NotImplementedError(
        "named_sharding: DTensor placements are not ported yet (ROADMAP "
        "Queue 1 item 4)")


class CommunicateTopology:
    """The rank arithmetic of a hybrid grid: ranks laid out row-major over
    `dims` named `hybrid_group_names`."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"), dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = None
        self._world_size = int(np.prod(dims))
        arr = np.arange(self._world_size).reshape(dims)
        self._rank_to_coord = {}
        self._coord_to_rank = {}
        for coord in np.ndindex(*dims):
            r = int(arr[coord])
            self._rank_to_coord[r] = coord
            self._coord_to_rank[coord] = r

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **kwargs):
        coord = tuple(kwargs[n] for n in self._parallel_names)
        return self._coord_to_rank[coord]

    def get_coord(self, rank):
        return self._rank_to_coord[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return sorted(
            r for r, c in self._rank_to_coord.items() if c[axis] == index)

    def get_comm_list(self, axis_name):
        axis = self._parallel_names.index(axis_name)
        other_dims = [d for i, d in enumerate(self._dims) if i != axis]
        groups = []
        for other in np.ndindex(*other_dims):
            group = []
            for i in range(self._dims[axis]):
                coord = list(other)
                coord.insert(axis, i)
                group.append(self._coord_to_rank[tuple(coord)])
            groups.append(group)
        return groups


class HybridCommunicateGroup:
    """The reference's facade over the mesh and a topology: sizes and this
    rank's coordinate per Paddle axis name ("data", "pipe", "model",
    "sharding", "sep"). Group handles are the mesh's axis names, which the
    collectives take as `group`."""

    _AXES = {"data": "dp", "pipe": "pp", "model": "tp",
             "sharding": "sharding", "sep": "sep"}

    def __init__(self, topology: CommunicateTopology = None,
                 mesh: DeviceMesh = None):
        from . import env as _env

        self._topo = topology
        self._mesh = mesh or get_mesh(optional=True)
        self.global_rank = _env.get_rank()

    def _size(self, paddle_name):
        if self._topo is not None:
            return self._topo.get_dim(paddle_name)
        name = self._AXES[paddle_name]
        m = self._mesh
        if m is None or name not in (m.mesh_dim_names or ()):
            return 1
        return int(m[name].size())

    def _rank_in(self, paddle_name):
        if self._topo is not None:
            coord = self._topo.get_coord(self.global_rank)
            return coord[self._topo._parallel_names.index(paddle_name)]
        name = self._AXES[paddle_name]
        m = self._mesh
        if m is None or name not in (m.mesh_dim_names or ()):
            return 0
        return int(m.get_local_rank(name))

    def get_data_parallel_world_size(self):
        return self._size("data")

    def get_data_parallel_rank(self):
        return self._rank_in("data")

    def get_model_parallel_world_size(self):
        return self._size("model")

    def get_model_parallel_rank(self):
        return self._rank_in("model")

    def get_pipe_parallel_world_size(self):
        return self._size("pipe")

    def get_stage_id(self):
        return self._rank_in("pipe")

    def get_sharding_parallel_world_size(self):
        return self._size("sharding")

    def get_sharding_parallel_rank(self):
        return self._rank_in("sharding")

    def get_parallel_mode(self):
        if self._size("model") > 1 or self._size("pipe") > 1:
            return "hybrid"
        if self._size("sharding") > 1:
            return "sharding"
        return "data" if self._size("data") > 1 else "single"

    def get_data_parallel_group(self):
        return "dp"

    def get_model_parallel_group(self):
        return "tp"

    def get_pipe_parallel_group(self):
        return "pp"

    def get_sharding_parallel_group(self):
        return "sharding"

    def get_check_parallel_group(self, *a):
        return None

    def get_rank_from_stage(self, stage_id, **kwargs):
        if self._topo is None:
            return stage_id
        coord = list(self._topo.get_coord(self.global_rank))
        coord[self._topo._parallel_names.index("pipe")] = stage_id
        return self._topo._coord_to_rank[tuple(coord)]
