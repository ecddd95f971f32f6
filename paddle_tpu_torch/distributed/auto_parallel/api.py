"""`ProcessMesh`, the placements and `shard_tensor` / `reshard` /
`shard_layer` / `dtensor_from_fn` / `shard_op` (counterpart of
`paddle_tpu/distributed/auto_parallel/api.py`) over
`torch.distributed.tensor`, one process a rank.

The reference maps a `ProcessMesh` onto a JAX `Mesh` and places arrays by
`NamedSharding`; here a `ProcessMesh` builds a `DeviceMesh` over the
process group's ranks (`device_mesh`, every rank of the group calls it
the first time) and a sharded tensor is a DTensor, this rank holding its
local shard. The placements are torch's (`Shard`, `Replicate`,
`Partial`) with Paddle's methods (`is_shard`, `is_replicated`,
`is_partial`). `shard_tensor` returns a new DTensor (a torch tensor cannot
become one in place; Paddle's returns a new tensor too), carrying
`dist_attr` and `process_mesh`; its `placements` are DTensor's own. A
`Partial` placement of a full value keeps the value: `full_tensor()`
equals it (the reference treats it as replicated).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch
from torch.distributed import tensor as _dt


class Placement(_dt.Placement):
    """The placements' common base (torch's `Placement`)."""


class Shard(_dt.Shard):
    """Tensor dimension `dim` split over the mesh dimension."""

    def __init__(self, dim: int):
        super().__init__(int(dim))

    def is_replicated(self):
        return False


class Replicate(_dt.Replicate):
    def is_replicated(self):
        return True


class Partial(_dt.Partial):
    """A partial value over the mesh dimension (pending a reduction of
    `reduce_type`)."""

    def __init__(self, reduce_type="sum"):
        super().__init__(reduce_type)

    @property
    def reduce_type(self):
        return self.reduce_op

    def is_replicated(self):
        return False


_meshes: dict = {}


class ProcessMesh:
    """An N-d grid of process ids (ranks) named by `dim_names` (default
    d0, d1, ...)."""

    def __init__(self, mesh: Union[Sequence, np.ndarray],
                 dim_names: Optional[List[str]] = None,
                 shape=None, process_ids=None):
        arr = np.asarray(mesh)
        self._process_ids = arr
        self._dim_names = list(dim_names) if dim_names else [
            f"d{i}" for i in range(arr.ndim)]
        if len(self._dim_names) != arr.ndim:
            raise ValueError("dim_names must match mesh rank")

    @property
    def shape(self):
        return list(self._process_ids.shape)

    @property
    def dim_names(self):
        return list(self._dim_names)

    @property
    def process_ids(self):
        return self._process_ids.reshape(-1).tolist()

    def get_dim_size(self, name):
        return self._process_ids.shape[self._dim_names.index(name)]

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and self._dim_names == other._dim_names
                and np.array_equal(self._process_ids, other._process_ids))

    def __hash__(self):
        return hash((tuple(self._dim_names), self._process_ids.tobytes(),
                     self._process_ids.shape))

    def __repr__(self):
        return (f"ProcessMesh(shape={self.shape}, "
                f"dim_names={self._dim_names})")

    def device_mesh(self):
        """The `DeviceMesh` of these ranks on this rank's device type
        (built once a process; the first call is collective over the
        default group, as it makes each dimension's group)."""
        import torch.distributed as dist

        from .. import env as _env

        world = dist.get_world_size() if dist.is_initialized() else 1
        flat = self._process_ids.reshape(-1)
        if flat.max() >= world:
            raise ValueError(
                f"ProcessMesh names process {int(flat.max())} but only "
                f"{world} devices (ranks) are in the process group")
        key = (tuple(self._dim_names), self._process_ids.tobytes(),
               self._process_ids.shape)
        if key not in _meshes:
            dev = _env.device()
            _meshes[key] = _dt.DeviceMesh(
                dev.type if dev is not None else "cpu",
                torch.as_tensor(self._process_ids, dtype=torch.int),
                mesh_dim_names=tuple(self._dim_names))
        return _meshes[key]


_global_mesh: Optional[ProcessMesh] = None


def set_mesh(mesh: ProcessMesh):
    global _global_mesh
    _global_mesh = mesh
    return mesh


def get_mesh() -> Optional[ProcessMesh]:
    return _global_mesh


class DistAttr:
    """A tensor's mesh and placements (`dims_mapping`: tensor dim -> mesh
    dim, the reference's form)."""

    def __init__(self, mesh: ProcessMesh, placements: List[Placement]):
        self.process_mesh = mesh
        self.placements = list(placements)

    @property
    def dims_mapping(self):
        mapping = {}
        for mesh_dim, p in enumerate(self.placements):
            if isinstance(p, _dt.Shard):
                mapping[p.dim] = mesh_dim
        return mapping


def _tag(t, mesh, placements):
    t.dist_attr = DistAttr(mesh, placements)
    t.process_mesh = mesh
    return t


def shard_tensor(x, mesh: ProcessMesh, placements: List[Placement],
                 dtype=None, place=None, stop_gradient=None):
    """`x` (the full value, the same on every rank; a tensor or
    array-like) as a DTensor over `mesh` with `placements` (one a mesh
    dimension): this rank keeps its shard, with no communication. `dtype`
    casts first; `stop_gradient` False makes it require gradients."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if dtype is not None:
        from ...framework.device import torch_dtype

        t = t.to(torch_dtype(dtype))
    if isinstance(t, _dt.DTensor):
        return reshard(t, mesh, placements)
    from .. import env as _env

    dev = _env.device()
    if dev is not None:
        t = t.to(dev)
    out = _dt.distribute_tensor(t.detach(), mesh.device_mesh(),
                                list(placements), src_data_rank=None)
    if stop_gradient is not None:
        out.requires_grad_(not stop_gradient)
    return _tag(out, mesh, placements)


def reshard(x, mesh: ProcessMesh, placements: List[Placement]):
    """`x` moved to `placements` over `mesh` (a DTensor over the same mesh
    is redistributed by collectives; a plain tensor is sharded)."""
    if isinstance(x, _dt.DTensor) and x.device_mesh is mesh.device_mesh():
        return _tag(x.redistribute(mesh.device_mesh(), list(placements)),
                    mesh, placements)
    if isinstance(x, _dt.DTensor):
        x = x.full_tensor()
    return shard_tensor(x, mesh, placements)


def shard_layer(layer, process_mesh: ProcessMesh, shard_fn=None,
                input_fn=None, output_fn=None):
    """Each sublayer's own parameters as DTensor parameters:
    `shard_fn(name, sublayer, mesh)` places them (assigning what
    `shard_tensor` returns), or each is replicated. `input_fn(inputs,
    mesh)` and `output_fn(outputs, mesh)` become forward pre- and post-
    hooks."""
    for name, sub in list(layer.named_modules()):
        if shard_fn is not None:
            shard_fn(name, sub, process_mesh)
            continue
        for pname, p in list(sub.named_parameters(recurse=False)):
            if not isinstance(p, _dt.DTensor):
                rep = [Replicate()] * len(process_mesh.shape)
                sub.register_parameter(pname, torch.nn.Parameter(
                    shard_tensor(p.detach(), process_mesh, rep),
                    requires_grad=p.requires_grad))
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda lyr, inp: input_fn(inp, process_mesh))
    if output_fn is not None:
        layer.register_forward_hook(
            lambda lyr, inp, out: output_fn(out, process_mesh))
    return layer


def dtensor_from_fn(fn, mesh: ProcessMesh, placements: List[Placement],
                    *args, **kwargs):
    """`fn(*args, **kwargs)` distributed over `mesh` by `placements`."""
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def shard_op(op_fn, mesh: ProcessMesh, in_placements=None,
             out_placements=None):
    """`op_fn` wrapped so its positional tensor inputs (and its outputs)
    are placed by `in_placements` (`out_placements`), one entry (or None:
    left as it is) an input (output); a count that does not match
    raises."""
    def wrapped(*args, **kwargs):
        if in_placements is not None:
            if len(in_placements) != len(args):
                raise ValueError(
                    f"shard_op: {len(in_placements)} in_placements for "
                    f"{len(args)} positional args")
            args = tuple(
                shard_tensor(a, mesh, p) if p is not None and isinstance(
                    a, torch.Tensor) else a
                for a, p in zip(args, in_placements))
        out = op_fn(*args, **kwargs)
        if out_placements is not None:
            seq = isinstance(out, (list, tuple))
            outs = list(out) if seq else [out]
            if len(out_placements) != len(outs):
                raise ValueError(
                    f"shard_op: {len(out_placements)} out_placements for "
                    f"{len(outs)} outputs")
            outs = [shard_tensor(o, mesh, p)
                    if p is not None and isinstance(o, torch.Tensor) else o
                    for o, p in zip(outs, out_placements)]
            if not seq:
                return outs[0]
            if hasattr(out, "_fields"):
                return type(out)(*outs)
            return type(out)(outs)
        return out

    return wrapped
