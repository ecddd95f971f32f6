"""Sequence parallelism (counterpart of
`paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py`):
Megatron-SP's scatter / gather ops, which turn a tensor-parallel block's
all_reduce into an all_gather before it and a reduce_scatter after it, the
activations between blocks split along the sequence.

The axis is the reference's `_sp_axis`: the global mesh's "sp", else
"sep", else "tp", the first of degree > 1 (none: every op is the
identity). The ops are autograd functions over that axis's group:

- `ScatterOp`: this rank's slice forward, all_gather backward;
- `GatherOp`: all_gather forward, this rank's slice backward;
- `AllGatherOp`: all_gather forward, reduce_scatter backward;
- `ReduceScatterOp`: reduce_scatter forward, all_gather backward.

The reference's GSPMD reduces the gradients of parameters that see a
sequence shard; here each rank holds only its shard's contribution, so
`register_sequence_parallel_allreduce_hooks` all_reduces, over the axis,
the gradient of every parameter `mark_as_sequence_parallel_parameter`
marked (a norm's weight between the blocks, a row linear's bias).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ... import collective as _collective
from ... import mesh as _mesh
from ....nn import functional as F
from ..layers.mpu.mp_layers import ColumnParallelLinear, RowParallelLinear


def _sp_axis():
    m = _mesh.get_mesh(optional=True)
    if m is None:
        return None
    for name in ("sp", "sep", "tp"):
        if name in (m.mesh_dim_names or ()) and m[name].size() > 1:
            return name
    return None


def _axis_rank(ax):
    pg, _ = _collective._resolve(ax)
    return dist.get_rank(pg)


def _split(x, ax, axis):
    n = _collective._size(ax)
    return torch.chunk(x, n, dim=axis)[_axis_rank(ax)].contiguous()


def _gather(x, ax, axis):
    return _collective.all_gather_jit(x.contiguous(), ax, axis=axis)


def _reduce_scatter(x, ax, axis):
    return _collective.psum_scatter(x.contiguous(), ax,
                                    scatter_dimension=axis)


class _SeqOp(torch.autograd.Function):
    """`fwd` along `axis` over the group of `ax` forward, `bwd` backward
    (each one of `_split`, `_gather`, `_reduce_scatter`)."""

    @staticmethod
    def forward(ctx, x, ax, axis, fwd, bwd):
        ctx.ax, ctx.axis, ctx.bwd = ax, axis, bwd
        return fwd(x, ax, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g, ctx.ax, ctx.axis), None, None, None, None


def _op(x, axis, fwd, bwd):
    ax = _sp_axis()
    return x if ax is None else _SeqOp.apply(x, ax, axis, fwd, bwd)


class ScatterOp:
    """Split activations along `axis` (forward scatter, backward
    gather)."""

    @staticmethod
    def apply(x, axis=0):
        return _op(x, axis, _split, _gather)


class GatherOp:
    """Gather activations along `axis` (forward all_gather, backward
    scatter)."""

    @staticmethod
    def apply(x, axis=0):
        return _op(x, axis, _gather, _split)


class AllGatherOp:
    """All_gather along `axis` (forward all_gather, backward
    reduce_scatter)."""

    @staticmethod
    def apply(x, axis=0):
        return _op(x, axis, _gather, _reduce_scatter)


class ReduceScatterOp:
    """Reduce_scatter along `axis` (forward reduce_scatter, backward
    all_gather)."""

    @staticmethod
    def apply(x, axis=0):
        return _op(x, axis, _reduce_scatter, _gather)


def mark_as_sequence_parallel_parameter(parameter):
    parameter.sequence_parallel = True
    return parameter


def register_sequence_parallel_allreduce_hooks(model, accumulation_steps=1,
                                               fuse_sequence_parallel_allreduce
                                               =False):
    """After backward has accumulated the gradient of each parameter of
    `model` marked sequence-parallel, all_reduce it (sum) over the
    sequence-parallel axis, once every `accumulation_steps` accumulations.
    A parameter is hooked once, however often this is called. Returns
    `model`."""
    ax = _sp_axis()
    if ax is None:
        return model
    k = max(int(accumulation_steps), 1)
    for p in model.parameters():
        if getattr(p, "sequence_parallel", False) and \
                not getattr(p, "_sp_allreduce_hook", False):
            count = [0]

            def hook(param, count=count):
                count[0] += 1
                if count[0] % k == 0:
                    _collective.all_reduce(param.grad, group=ax)

            p.register_post_accumulate_grad_hook(hook)
            p._sp_allreduce_hook = True
    return model


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """A column-parallel linear whose input is split along the sequence
    (axis 1 of [b, s, h]): the input is all_gathered (`AllGatherOp`:
    its gradient reduce_scattered), multiplied by this rank's column shard
    `weight` [in, out / tp], and left split by columns."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=False, fuse_matmul_bias=False,
                 mp_group=None, name=None, dtype=torch.float32, device=None):
        if gather_output:
            raise ValueError("ColumnSequenceParallelLinear: gather_output "
                             "must be False (its output stays split by "
                             "columns)")
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         False, fuse_matmul_bias, mp_group, name, dtype,
                         device)

    def forward(self, x):
        if self.world_size == 1:
            return F.linear(x, self.weight, self.bias)
        return F.linear(AllGatherOp.apply(x, axis=1), self.weight,
                        self.bias)


class RowSequenceParallelLinear(RowParallelLinear):
    """A row-parallel linear whose output is split along the sequence:
    this rank's row shard `weight` [in / tp, out], the partial products
    reduce_scattered along axis 1 (`ReduceScatterOp`: the gradient
    all_gathered), then the replicated `bias`, which sees a sequence shard
    and is marked sequence-parallel."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 dtype=torch.float32, device=None):
        if not input_is_parallel:
            raise ValueError("RowSequenceParallelLinear: input_is_parallel "
                             "must be True")
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         True, fuse_matmul_bias, mp_group, name, dtype,
                         device)
        if self.world_size > 1 and self.bias is not None:
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        if self.world_size == 1:
            return F.linear(x, self.weight, self.bias)
        out = ReduceScatterOp.apply(F.linear(x, self.weight), axis=1)
        return out if self.bias is None else out + self.bias.to(out.dtype)
