"""The collectives (counterpart of `paddle_tpu/distributed/collective.py`)
over `torch.distributed`, one process a rank.

`group` is None (the default group: every rank), a mesh axis name ("dp",
"tp", ...: that axis's group of the global mesh, `distributed.mesh`), or a
`Group` from `new_group`. Without a group to talk over (no process group
at all, or an axis the mesh does not have) every op is the identity of
one rank, as the reference's are at world 1; a group of one rank that
exists (world 1) runs its ops on the backend. With the same
tensor on every rank the results equal the reference's eager ones (its SUM
over a replicated input gives world * x); with shard r on rank r, rank r
gets what the reference's `shard_map` gives shard r. The functional forms
the reference runs only under jit (`psum`, `all_gather_jit`,
`psum_scatter`, `ppermute`, `all_to_all_jit`) run eagerly here over the
named axis and return new tensors.

AVG is SUM divided by the group's size on every backend (gloo has no AVG),
which is the reference's `pmean`. Over gloo (the backend a caller names
for CUDA tensors, `distributed.env`) CUDA tensors take all_reduce,
broadcast and barrier, what gloo runs on the card; its other ops take CPU
tensors and raise gloo's error on CUDA ones. `calls` counts each op's invocations, as the
kernel wrappers count launches. The reference's telemetry, chaos sites
and collective watchdog are not ported (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import collections
import datetime

import torch
import torch.distributed as dist

from . import mesh as _mesh

calls: collections.Counter = collections.Counter()


def reset_calls():
    calls.clear()


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
              "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT,
              "avg": dist.ReduceOp.SUM}


class Group:
    """A process group as Paddle shows it: `id`, `ranks` (global),
    `nranks`, this process's `rank` in it (-1 outside), `process_group`
    (torch's)."""

    def __init__(self, gid, ranks, process_group):
        self.id = gid
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.process_group = process_group
        me = dist.get_rank() if dist.is_initialized() else 0
        self.rank = self.ranks.index(me) if me in self.ranks else -1

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


_groups = {}


def _resolve(group):
    """(torch process group, or None for the default one; its size) of
    `group`, or None when there is no group to talk over: no process
    group at all, or a mesh axis the global mesh does not have. Then
    every op is the identity of one rank. A group of one rank that exists
    (world 1, an axis of degree 1) runs its collectives on the backend."""
    if isinstance(group, Group):
        return group.process_group, group.nranks
    if not dist.is_initialized():
        return None
    if group is None:
        return None, dist.get_world_size()
    if isinstance(group, str):
        m = _mesh.get_mesh(optional=True)
        if m is None or group not in (m.mesh_dim_names or ()):
            return None
        sub = m[group]
        return sub.get_group(), sub.size()
    return group, dist.get_world_size(group)


def _pg(group):
    """The torch group of a point-to-point op (raises without one)."""
    g = _resolve(group)
    if g is None:
        raise RuntimeError("point-to-point ops need a process group: call "
                           "init_parallel_env first")
    return g[0]


def _size(group):
    g = _resolve(group)
    return 1 if g is None else g[1]


def _global_rank(pg, group_rank):
    return group_rank if pg is None else \
        dist.get_global_rank(pg, group_rank)


def _finish_avg(tensor, op, n):
    if op == ReduceOp.AVG:
        if not tensor.is_floating_point():
            raise TypeError("ReduceOp.AVG takes floating tensors")
        tensor.div_(n)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In place over the group; returns `tensor`."""
    calls["all_reduce"] += 1
    g = _resolve(group)
    if g is None:
        return tensor
    pg, n = g
    dist.all_reduce(tensor, _TORCH_OPS[op], group=pg)
    _finish_avg(tensor, op, n)
    return tensor


def broadcast(tensor, src=0, group=None, sync_op=True):
    """`tensor` of global rank `src`, in place on every rank."""
    calls["broadcast"] += 1
    g = _resolve(group)
    if g is not None:
        dist.broadcast(tensor, src, group=g[0])
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction lands in `tensor` on global rank `dst`."""
    calls["reduce"] += 1
    g = _resolve(group)
    if g is None:
        return tensor
    pg, n = g
    dist.reduce(tensor, dst, _TORCH_OPS[op], group=pg)
    if dist.get_rank() == dst:
        _finish_avg(tensor, op, n)
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Every rank's `tensor`, in group-rank order, appended to an empty
    `tensor_list` (or copied into its `nranks` tensors)."""
    calls["all_gather"] += 1
    g = _resolve(group)
    pg, n = g if g is not None else (None, 1)
    if g is None:
        out = [tensor.clone()]
    else:
        out = [torch.empty_like(tensor) for _ in range(n)]
        dist.all_gather(out, tensor.contiguous(), group=pg)
    if tensor_list:
        if len(tensor_list) != n:
            raise ValueError(f"all_gather: tensor_list holds "
                             f"{len(tensor_list)} tensors for {n} ranks")
        for t, o in zip(tensor_list, out):
            t.copy_(o)
    else:
        tensor_list.extend(out)
    return tensor_list


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """`tensor` = the reduction of every rank's `tensor_list[r]`, on group
    rank r."""
    calls["reduce_scatter"] += 1
    g = _resolve(group)
    if g is None:
        tensor.copy_(tensor_list[0])
        return tensor
    pg, n = g
    dist.reduce_scatter(tensor, [t.contiguous() for t in tensor_list],
                        _TORCH_OPS[op], group=pg)
    _finish_avg(tensor, op, n)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """`tensor_list[r]` of global rank `src` into `tensor` on group rank
    r."""
    calls["scatter"] += 1
    g = _resolve(group)
    if g is None:
        if tensor_list:
            tensor.copy_(tensor_list[src if src < len(tensor_list) else 0])
        return tensor
    ins = [t.contiguous() for t in tensor_list] \
        if dist.get_rank() == src else None
    dist.scatter(tensor, ins, src, group=g[0])
    return tensor


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every rank's `tensor` appended to `gather_list` on global rank
    `dst`."""
    calls["gather"] += 1
    g = _resolve(group)
    if g is None:
        if gather_list is not None:
            gather_list.append(tensor.clone())
        return tensor
    pg, n = g
    out = [torch.empty_like(tensor) for _ in range(n)] \
        if dist.get_rank() == dst else None
    dist.gather(tensor.contiguous(), out, dst, group=pg)
    if out is not None and gather_list is not None:
        gather_list.extend(out)
    return tensor


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             sync_op=True):
    """Group rank r's `in_tensor_list[j]` becomes group rank j's
    `out_tensor_list[r]` (appended to a list given empty or None)."""
    calls["alltoall"] += 1
    g = _resolve(group)
    if out_tensor_list is None:
        out_tensor_list = []
    if g is None:
        out_tensor_list.extend(t.clone() for t in in_tensor_list)
        return out_tensor_list
    ins = [t.contiguous() for t in in_tensor_list]
    outs = [torch.empty_like(t) for t in ins]
    dist.all_to_all(outs, ins, group=g[0])
    out_tensor_list.extend(outs)
    return out_tensor_list


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """`in_tensor` split along axis 0 (evenly, or by `in_split_sizes`),
    piece j to group rank j; `out_tensor` the pieces received, in rank
    order."""
    calls["alltoall_single"] += 1
    g = _resolve(group)
    if g is None:
        out_tensor.copy_(in_tensor)
        return out_tensor
    dist.all_to_all_single(out_tensor, in_tensor.contiguous(),
                           out_split_sizes, in_split_sizes, group=g[0])
    return out_tensor


def send(tensor, dst=0, group=None, sync_op=True):
    calls["send"] += 1
    dist.send(tensor, dst, group=_pg(group))


def recv(tensor, src=0, group=None, sync_op=True):
    calls["recv"] += 1
    dist.recv(tensor, src, group=_pg(group))
    return tensor


def isend(tensor, dst=0, group=None):
    """An asynchronous send; returns its task (`wait()`)."""
    calls["isend"] += 1
    return dist.isend(tensor, dst, group=_pg(group))


def irecv(tensor, src=0, group=None):
    """An asynchronous receive into `tensor`; returns its task."""
    calls["irecv"] += 1
    return dist.irecv(tensor, src, group=_pg(group))


class P2POp:
    """One pending point-to-point op for `batch_isend_irecv`: `op` is
    `isend` or `irecv`, `peer` a global rank."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv):
            raise ValueError("P2POp: op must be distributed.isend or "
                             "distributed.irecv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """Start every op of the list together; returns their tasks."""
    calls["batch_isend_irecv"] += 1
    ops = []
    for op in p2p_op_list:
        pg = _pg(op.group)
        fn = dist.isend if op.op is isend else dist.irecv
        ops.append(dist.P2POp(fn, op.tensor, op.peer, group=pg))
    return dist.batch_isend_irecv(ops)


def barrier(group=None):
    calls["barrier"] += 1
    g = _resolve(group)
    if g is not None:
        dist.barrier(group=g[0])


def wait(tensor, group=None, use_calc_stream=True):
    """Block the host until the work queued on `tensor`'s stream is
    done."""
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


def new_group(ranks=None, backend=None, timeout=None):
    """A group of the global `ranks` (every rank when None); every rank
    must call it, as in Paddle. `backend` "gloo" or "nccl" (default: the
    default group's); `timeout` in seconds."""
    if not dist.is_initialized():
        raise RuntimeError("new_group: call init_parallel_env first")
    ranks = list(range(dist.get_world_size())) if ranks is None \
        else sorted(int(r) for r in ranks)
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=float(timeout))}
    pg = dist.new_group(ranks, backend=backend, **kw)
    g = Group(len(_groups) + 1, ranks, pg)
    _groups[g.id] = g
    return g


def get_group(id=0):  # noqa: A002
    """The group of `id` (0: every rank), or None."""
    if id == 0:
        if not dist.is_initialized():
            return None
        return Group(0, range(dist.get_world_size()), None)
    return _groups.get(id)


def get_backend(group=None):
    """"nccl" or "gloo" (the reference's: "xla"); None without a
    process group."""
    g = _resolve(group)
    return None if g is None else dist.get_backend(g[0])


def destroy_process_group(group=None):
    """Tear down `group`, or with None the mesh and the default group."""
    from . import env as _env

    if group is None:
        _mesh.set_mesh(None)
        _groups.clear()
        if dist.is_initialized():
            dist.destroy_process_group()
        _env._reset()
        return
    g = _resolve(group)
    if g is not None and g[0] is not None:
        dist.destroy_process_group(g[0])
    if isinstance(group, Group):
        _groups.pop(group.id, None)


def is_available():
    return dist.is_available()


def gloo_barrier():
    """A barrier over every rank (the port's groups are all host-side
    rendezvous-capable)."""
    barrier()


def all_gather_object(object_list, obj, group=None):
    """Every rank's picklable `obj`, in group-rank order, appended to
    `object_list`."""
    calls["all_gather_object"] += 1
    g = _resolve(group)
    if g is None:
        object_list.append(obj)
        return
    pg, n = g
    out = [None] * n
    dist.all_gather_object(out, obj, group=pg)
    object_list.extend(out)


def broadcast_object_list(object_list, src=0, group=None):
    """`object_list` of global rank `src`, in place on every rank."""
    calls["broadcast_object_list"] += 1
    g = _resolve(group)
    if g is not None:
        dist.broadcast_object_list(object_list, src, group=g[0])


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """`in_object_list[r]` of global rank `src` appended to
    `out_object_list` on group rank r."""
    calls["scatter_object_list"] += 1
    g = _resolve(group)
    if g is None:
        src_list = in_object_list or []
        out_object_list.extend(src_list[:1] or [None])
        return
    out = [None]
    dist.scatter_object_list(
        out, in_object_list if dist.get_rank() == src else None, src,
        group=g[0])
    out_object_list.extend(out)


# the reference's jit-path helpers, eager over the named axis's group


def psum(x, axis_name):
    """The sum of every rank's `x` over the axis (a new tensor)."""
    return all_reduce(x.clone(), ReduceOp.SUM, group=axis_name)


def all_gather_jit(x, axis_name, axis=0, tiled=True):
    """Every rank's `x` concatenated along `axis` (tiled) or stacked on a
    new `axis`."""
    parts = all_gather([], x, group=axis_name)
    return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)


def psum_scatter(x, axis_name, scatter_dimension=0, tiled=True):
    """The sum over the axis of every rank's `x`, split along
    `scatter_dimension`: rank r keeps piece r (tiled), or, untiled, index
    r of that dimension (whose size is the axis's)."""
    n = _size(axis_name)
    pieces = [p.contiguous() for p in torch.chunk(x, n, scatter_dimension)] \
        if tiled else [p.contiguous() for p in x.unbind(scatter_dimension)]
    out = torch.empty_like(pieces[0])
    return reduce_scatter(out, pieces, ReduceOp.SUM, group=axis_name)


def ppermute(x, axis_name, perm):
    """`x` sent along the (source, destination) pairs of `perm` (axis
    ranks); a rank no pair sends to gets zeros, as in the reference."""
    g = _resolve(axis_name)
    if g is None:
        return x.clone() if (0, 0) in perm else torch.zeros_like(x)
    pg = g[0]
    me = dist.get_rank(pg) if pg is not None else dist.get_rank()
    out = torch.zeros_like(x)
    ops = [P2POp(isend, x.contiguous(), _global_rank(pg, d), axis_name)
           for s, d in perm if s == me and d != me]
    ops += [P2POp(irecv, out, _global_rank(pg, s), axis_name)
            for s, d in perm if d == me and s != me]
    if (me, me) in perm:
        out.copy_(x)
    if ops:
        for task in batch_isend_irecv(ops):
            task.wait()
    return out


def all_to_all_jit(x, axis_name, split_axis, concat_axis, tiled=True):
    """`x` split along `split_axis` into the axis's size of pieces, piece
    j to rank j; the pieces received concatenated along `concat_axis`."""
    n = _size(axis_name)
    pieces = [p.contiguous() for p in torch.chunk(x, n, split_axis)]
    got = alltoall(pieces, [], group=axis_name)
    if tiled:
        return torch.cat(got, concat_axis)
    return torch.stack([g.squeeze(split_axis) for g in got], concat_axis)

