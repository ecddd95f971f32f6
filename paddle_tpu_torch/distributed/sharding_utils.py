"""Sharding annotations over the global mesh (counterpart of
`paddle_tpu/distributed/sharding_utils.py`).

A spec names, per tensor dimension, a mesh axis or None (a tuple of axes
splits one dimension over several). The reference hands specs to GSPMD;
here `shard_tensor` returns this rank's DTensor shard over the global
`DeviceMesh` (`distributed.mesh`), and `mark_sharding` records the spec
on a parameter (`get_param_spec` reads it back) without moving it: the
port's parameters are plain per-rank tensors, sharded by the
tensor-parallel layers and ZeRO, which read no spec.
"""
from __future__ import annotations

from . import mesh as _mesh


def clean_spec(spec, mesh):
    """`spec` against `mesh` as a tuple: axis names the mesh lacks (a
    degree-1 axis) become None, tuples keep the axes it has."""
    if spec is None:
        return ()
    names = mesh.mesh_dim_names or ()
    clean = []
    for s in spec:
        if s is None:
            clean.append(None)
        elif isinstance(s, (tuple, list)):
            keep = tuple(a for a in s if a in names)
            clean.append(keep if keep else None)
        else:
            clean.append(s if s in names else None)
    return tuple(clean)


def in_manual_region(mesh=None) -> bool:
    """Always False: the reference asks whether it is tracing inside a
    `shard_map` with manual axes, where sharding constraints are refused;
    a process-per-rank port has no `shard_map`, every rank always runs its
    own program."""
    return False


def shard_tensor(x, *spec):
    """`x` (the full value on every rank) as a DTensor over the global
    mesh, split by `spec` (`mesh.named_sharding`); `x` itself without a
    mesh."""
    m = _mesh.get_mesh(optional=True)
    if m is None:
        return x
    from torch.distributed import tensor as _dt

    if isinstance(x, _dt.DTensor):
        return x.redistribute(m, _mesh.named_sharding(*spec))
    return _dt.distribute_tensor(x.detach(), m, _mesh.named_sharding(*spec),
                                 src_data_rank=None)


def mark_sharding(param, *spec):
    """Record `spec` on `param` (`sharding_spec`); returns `param`."""
    param.sharding_spec = tuple(spec)
    return param


def get_param_spec(param):
    return getattr(param, "sharding_spec", None)
