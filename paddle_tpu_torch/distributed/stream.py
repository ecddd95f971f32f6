"""`paddle.distributed.stream` (counterpart of
`paddle_tpu/distributed/stream.py`): the stream-variant collectives. The
port's collectives run on torch.distributed's own streams and complete
before they return, so `sync_op` and `use_calc_stream` are accepted and
change nothing."""
from __future__ import annotations

from . import collective as _c


def all_reduce(tensor, op=None, group=None, sync_op=True,
               use_calc_stream=False):
    return _c.all_reduce(tensor, op if op is not None else _c.ReduceOp.SUM,
                         group=group, sync_op=sync_op)


def all_gather(tensor_or_tensor_list, tensor, group=None, sync_op=True,
               use_calc_stream=False):
    return _c.all_gather(tensor_or_tensor_list, tensor, group=group,
                         sync_op=sync_op)


def broadcast(tensor, src=0, group=None, sync_op=True,
              use_calc_stream=False):
    return _c.broadcast(tensor, src=src, group=group, sync_op=sync_op)


def reduce(tensor, dst=0, op=None, group=None, sync_op=True,
           use_calc_stream=False):
    return _c.reduce(tensor, dst=dst,
                     op=op if op is not None else _c.ReduceOp.SUM,
                     group=group, sync_op=sync_op)


def reduce_scatter(tensor, tensor_or_tensor_list, op=None, group=None,
                   sync_op=True, use_calc_stream=False):
    return _c.reduce_scatter(tensor, tensor_or_tensor_list,
                             op=op if op is not None else _c.ReduceOp.SUM,
                             group=group, sync_op=sync_op)


def scatter(tensor, tensor_or_tensor_list=None, src=0, group=None,
            sync_op=True, use_calc_stream=False):
    return _c.scatter(tensor, tensor_or_tensor_list, src=src, group=group,
                      sync_op=sync_op)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True,
             use_calc_stream=False):
    return _c.alltoall(in_tensor_list, out_tensor_list, group=group,
                       sync_op=sync_op)


def send(tensor, dst=0, group=None, sync_op=True, use_calc_stream=False):
    return _c.send(tensor, dst=dst, group=group, sync_op=sync_op)


def recv(tensor, src=0, group=None, sync_op=True, use_calc_stream=False):
    return _c.recv(tensor, src=src, group=group, sync_op=sync_op)
