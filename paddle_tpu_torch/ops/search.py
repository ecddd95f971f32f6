"""Search and sort ops (counterpart of `paddle_tpu/ops/search.py`):
argmax, argmin, argsort, sort, topk, nonzero, searchsorted, kthvalue,
mode, bucketize.

`argmax` / `argmin` give int64 and drop the axis by default; `sort` gives
the values alone (stable); `topk` gives (values, int64 indices).
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as _dtype
from ..tensor import Tensor, apply_op, as_array  # noqa: F401


def _arg(fn, x, axis, keepdim, dtype):
    a = as_array(x)
    if axis is None:
        out = fn(a.reshape(-1))
        if keepdim:
            out = out.reshape([1] * a.dim())
    else:
        out = fn(a, int(axis), keepdim=keepdim)
    return out.to(_dtype.to_torch_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    a = as_array(x)
    # the reference sorts -x ascending (stable when descending)
    return torch.argsort(-a if descending else a, dim=int(axis),
                         stable=stable or descending)


def sort(x, axis=-1, descending=False, stable=False, name=None):
    def f(a):
        s = torch.sort(a, dim=int(axis), stable=True).values
        return torch.flip(s, [int(axis)]) if descending else s

    return apply_op(f, x, _name="sort")


def msort(x, name=None):
    """Sort along the first axis."""
    return sort(x, axis=0)


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    if isinstance(k, torch.Tensor):
        k = int(k.item())
    out = apply_op(lambda a: torch.topk(a, k, int(axis), largest, True), x,
                   _name="topk")
    return out.values, out.indices


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def f(a):
        s = torch.sort(a, dim=int(axis), stable=True)
        v = s.values.select(int(axis), k - 1)
        i = s.indices.select(int(axis), k - 1)
        if keepdim:
            v, i = v.unsqueeze(int(axis)), i.unsqueeze(int(axis))
        return v, i

    values, idx = apply_op(f, x, _name="kthvalue")
    return values, idx.detach()


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along `axis` (the smallest of a tie) and
    the last index it occurs at, on the host (the reference's numpy)."""
    t = as_array(x)
    a = t.detach().cpu().numpy()
    ax = int(axis) % a.ndim

    def mode_1d(v):
        vals, counts = np.unique(v, return_counts=True)
        best = vals[np.argmax(counts)]
        return best, np.where(v == best)[0][-1]

    vals = np.apply_along_axis(lambda v: mode_1d(v)[0], ax, a)
    idx = np.apply_along_axis(lambda v: mode_1d(v)[1], ax, a)
    if keepdim:
        vals, idx = np.expand_dims(vals, ax), np.expand_dims(idx, ax)
    return (torch.from_numpy(np.asarray(vals)).to(t.device),
            torch.from_numpy(np.asarray(idx, np.int64)).to(t.device))


def nonzero(x, as_tuple=False, name=None):
    a = as_array(x)
    nz = torch.nonzero(a)
    if as_tuple:
        return tuple(nz[:, i:i + 1] for i in range(a.dim()))
    return nz


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    seq = as_array(sorted_sequence)
    v = as_array(values, seq.device)
    return torch.searchsorted(seq, v, out_int32=out_int32, right=right)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def index_of_first(x, value):
    """The first index of `value` in a 1-D tensor, -1 if absent (a helper
    of the reference's, not Paddle's)."""
    idx = torch.nonzero(as_array(x) == value)
    return int(idx[0, 0]) if idx.numel() else -1
