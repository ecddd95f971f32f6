"""Megatron-style tensor-parallel layers (counterpart of
`paddle_tpu/distributed/fleet/layers/mpu/mp_layers.py`), as Paddle's own
mp_layers build them: each rank holds its **shard** of a weight as a plain
tensor, and the collectives are explicit autograd functions over the
tensor-parallel group (Paddle's `mp_ops`):

- `_c_identity`: identity forward, all_reduce (sum) backward;
- `_mp_allreduce`: all_reduce forward, identity backward;
- `_c_split` / `_c_concat`: this rank's slice of the last axis forward and
  the all_gather backward, and the other way round.

The reference keeps full-size weights with GSPMD sharding specs and lets
XLA insert the same collectives; its state holds full arrays where a rank
here holds its shard (`weights.llama_state_from_numpy(tp_rank=...)` slices
a full state, `weights.gather_llama_state` builds it back).

The group is `mp_group` (a `collective.Group` or a mesh axis name), by
default the global mesh's "tp" axis; it is read when the layer is built.
At degree 1 (no mesh, or a mesh without a "tp" axis) every class is the
single-card layer. Sharded parameters carry `is_distributed = True` and
`split_axis`, as Paddle's do (`HybridParallelClipGrad` and `TensorParallel`
read the first through `is_distributed`), and `tp_shard` = (rank, degree),
so that a checkpoint can place the shard in the whole tensor
(`weights.param_pieces`).
Weights are allocated uninitialised on `device` in `dtype`, as
`nn.Linear`'s: the model fills or loads them. `weight_attr` takes only
None, as `nn.Embedding`'s; `name` is unused.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from .... import collective as _collective
from .....framework import amp_state as _amp
from .....nn import functional as F
from .....nn.layers import Linear
from .....nn.layers import ParallelCrossEntropy  # noqa: F401


def tp_group(mp_group=None):
    """(group, degree, rank) of the tensor-parallel group: `mp_group`, or
    the global mesh's "tp" axis; degree 1 and rank 0 without one."""
    group = "tp" if mp_group is None else mp_group
    g = _collective._resolve(group)
    if g is None or g[1] == 1:
        return group, 1, 0
    return group, g[1], dist.get_rank(g[0]) if g[0] is not None \
        else dist.get_rank()


def _divide(n, tp, what):
    if n % tp:
        raise ValueError(f"{what} {n} is not divisible by the "
                         f"tensor-parallel degree {tp}")
    return n // tp


def _no_attr(weight_attr, cls):
    if weight_attr is not None:
        raise NotImplementedError(
            f"{cls}(weight_attr=...): parameter attributes are not ported "
            "(pass None)")


def _distributed(p, axis, rank, degree):
    p.is_distributed = True
    p.split_axis = axis
    p.tp_shard = (rank, degree)
    return p


def is_distributed(p):
    """True for a parameter a tensor-parallel layer holds a shard of (its
    `is_distributed` attribute; a plain tensor's `is_distributed` is
    torch's method of that name)."""
    return getattr(p, "is_distributed", False) is True


def _all_reduce(x, group, op=_collective.ReduceOp.SUM):
    """A reduced copy of `x` (contiguous)."""
    return _collective.all_reduce(x.contiguous().clone(), op=op, group=group)


def _gather_last(x, group):
    """Every rank's `x` concatenated along the last axis, in rank order."""
    parts = _collective.all_gather([], x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _split_last(x, tp, rank):
    n = _divide(x.shape[-1], tp, "last axis")
    return x[..., rank * n:(rank + 1) * n].contiguous()


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _MpAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tp, rank):
        ctx.group = group
        return _split_last(x, tp, rank)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group), None, None, None


class _CConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tp, rank):
        ctx.group, ctx.tp, ctx.rank = group, tp, rank
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _split_last(g, ctx.tp, ctx.rank), None, None, None


def _c_identity(x, group):
    return _CIdentity.apply(x, group)


def _mp_allreduce(x, group):
    return _MpAllreduce.apply(x, group)


def _c_split(x, group):
    _, tp, rank = tp_group(group)
    return x if tp == 1 else _CSplit.apply(x, group, tp, rank)


def _c_concat(x, group):
    """Every rank's last-axis shard of `x` gathered into the whole (the
    identity at degree 1)."""
    _, tp, rank = tp_group(group)
    return x if tp == 1 else _CConcat.apply(x, group, tp, rank)


class ColumnParallelLinear(Linear):
    """y = x @ W + b with W [in, out] split by columns: this rank holds
    `weight` [in, out / tp] and `bias` [out / tp] (a `Linear` of that
    shape). The input's gradient is all_reduced (`_c_identity`);
    `gather_output` gathers the columns of y (`_c_concat`), else y stays
    this rank's [..., out / tp]."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, dtype=torch.float32, device=None):
        _no_attr(weight_attr, "ColumnParallelLinear")
        group, tp, rank = tp_group(mp_group)
        super().__init__(in_features,
                         _divide(out_features, tp, "out_features"),
                         dtype=dtype, device=device, has_bias=bool(has_bias))
        self._group, self.world_size, self.rank = group, tp, rank
        self.gather_output = gather_output
        self.in_features, self.out_features = in_features, out_features
        if self.world_size > 1:
            _distributed(self.weight, 1, rank, tp)
            if self.bias is not None:
                _distributed(self.bias, 0, rank, tp)

    def forward(self, x):
        if self.world_size == 1:
            return F.linear(x, self.weight, self.bias)
        out = F.linear(_c_identity(x, self._group), self.weight, self.bias)
        return _c_concat(out, self._group) if self.gather_output else out


class RowParallelLinear(Linear):
    """y = x @ W + b with W [in, out] split by rows: this rank holds
    `weight` [in / tp, out] (a `Linear` of that shape, its bias
    replicated); the partial products are all_reduced
    (`_mp_allreduce`) and the replicated `bias` [out] added once, after.
    Without `input_is_parallel` the full x is split first (`_c_split`)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 dtype=torch.float32, device=None):
        _no_attr(weight_attr, "RowParallelLinear")
        group, tp, rank = tp_group(mp_group)
        super().__init__(_divide(in_features, tp, "in_features"),
                         out_features, dtype=dtype, device=device,
                         has_bias=bool(has_bias))
        self._group, self.world_size, self.rank = group, tp, rank
        self.input_is_parallel = input_is_parallel
        self.in_features, self.out_features = in_features, out_features
        if self.world_size > 1:
            _distributed(self.weight, 0, rank, tp)

    def forward(self, x):
        if self.world_size == 1:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = _c_split(x, self._group)
        out = _mp_allreduce(F.linear(x, self.weight), self._group)
        if self.bias is None:
            return out
        out, bias = _amp.cast_inputs("linear", out, self.bias)
        return out + bias


class VocabParallelEmbedding(nn.Module):
    """An embedding whose vocab rows are split over the group: this rank
    holds rows [rank * vocab / tp, (rank + 1) * vocab / tp) as `weight`;
    ids outside that range read zero rows, and the ranks' lookups are
    all_reduced (Paddle's `c_embedding`)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, dtype=torch.float32, device=None):
        super().__init__()
        _no_attr(weight_attr, "VocabParallelEmbedding")
        self._group, self.world_size, self.rank = tp_group(mp_group)
        self.num_embeddings = num_embeddings
        self.per_rank = _divide(num_embeddings, self.world_size,
                                "the vocabulary (num_embeddings)")
        self.vocab_start = self.rank * self.per_rank
        self.weight = nn.Parameter(torch.empty(
            self.per_rank, embedding_dim, dtype=dtype, device=device))
        if self.world_size > 1:
            _distributed(self.weight, 0, self.rank, self.world_size)

    def forward(self, x):
        if self.world_size == 1:
            return F.embedding(x, self.weight)
        local = x - self.vocab_start
        outside = (local < 0) | (local >= self.per_rank)
        out = F.embedding(local.masked_fill(outside, 0), self.weight)
        out = out.masked_fill(outside[..., None], 0)
        return _mp_allreduce(out, self._group)


class _ParallelCE(torch.autograd.Function):
    """Softmax cross entropy over vocab-split logits (Paddle's
    `c_softmax_with_cross_entropy`): the row max all_reduced with MAX, the
    sum of exponentials and the picked logit with SUM, the label offset by
    this rank's first vocab row. The backward is softmax - onehot on the
    local shard, with no collective."""

    @staticmethod
    def forward(ctx, logits, label, group, rank, ignore_index):
        x = logits.float()
        n = x.shape[-1]
        lmax = _collective.all_reduce(x.amax(dim=-1, keepdim=True),
                                      op=_collective.ReduceOp.MAX,
                                      group=group)
        ex = torch.exp(x - lmax)
        sumexp = _collective.all_reduce(ex.sum(dim=-1, keepdim=True),
                                        group=group)
        local = label.long() - rank * n
        inside = (local >= 0) & (local < n)
        safe = torch.where(inside, local, 0)
        picked = (x.gather(-1, safe[..., None]) - lmax) * inside[..., None]
        picked = _collective.all_reduce(picked, group=group)
        valid = (label != ignore_index)[..., None]
        loss = torch.where(valid, torch.log(sumexp) - picked, 0.0)
        ctx.save_for_backward(ex.div_(sumexp), safe, inside, valid)
        ctx.dtype = logits.dtype
        return loss.to(logits.dtype)

    @staticmethod
    def backward(ctx, g):
        softmax, safe, inside, valid = ctx.saved_tensors
        g = torch.where(valid, g.float(), 0.0)
        grad = softmax * g
        grad.scatter_add_(-1, safe[..., None], -(inside[..., None] * g))
        return grad.to(ctx.dtype), None, None, None, None


def parallel_cross_entropy(input, label, group, rank, ignore_index=-100):
    """Per-token losses [..., 1] of vocab-split logits (`_ParallelCE`);
    `label` [...] or [..., 1]."""
    input, label = _amp.cast_inputs("cross_entropy", input, label)
    if label.dim() == input.dim():
        label = label.squeeze(-1)
    return _ParallelCE.apply(input, label, group, rank, ignore_index)
