"""Reductions (counterpart of `paddle_tpu/ops/reduction.py`): sum, mean,
max, min, prod, all, any, logsumexp, var, std, median, quantile and their
nan forms.

`sum` and `prod` of bool or integer inputs with no `dtype` give int64, as
the reference's (numpy's) promotion does; `var` and `std` are unbiased by
default.
"""
from __future__ import annotations

import builtins

import torch

from ..framework import dtype as _dtype
from ..tensor import Tensor, apply_op, as_array  # noqa: F401


def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _acc_dtype(a, dtype):
    if dtype:
        return _dtype.to_torch_dtype(dtype)
    if a.dtype == torch.bool or not (a.is_floating_point() or
                                     a.is_complex()):
        return torch.int64 if a.dtype != torch.uint8 else torch.uint64
    return None


def _dims(a, ax):
    return tuple(range(a.dim())) if ax is None else ax


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply_op(lambda a: torch.sum(a, _dims(a, ax), keepdim=keepdim,
                                        dtype=_acc_dtype(a, dtype)),
                    x, _name="sum")


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply_op(lambda a: torch.nansum(a, _dims(a, ax), keepdim=keepdim,
                                           dtype=_acc_dtype(a, dtype)),
                    x, _name="nansum")


def mean(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply_op(lambda a: torch.mean(a, _dims(a, ax), keepdim=keepdim),
                    x, _name="mean")


def nanmean(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply_op(lambda a: torch.nanmean(a, _dims(a, ax),
                                            keepdim=keepdim),
                    x, _name="nanmean")


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    ax = _axis(axis)

    def f(a):
        dt = _acc_dtype(a, dtype)
        if dt is not None:
            a = a.to(dt)
        for d in sorted((ax,) if isinstance(ax, int) else _dims(a, ax),
                        key=lambda d: d % builtins.max(a.dim(), 1),
                        reverse=True):
            a = torch.prod(a, d, keepdim=keepdim)
        return a

    return apply_op(f, x, _name="prod")


def max(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply_op(lambda a: torch.amax(a, _dims(a, ax), keepdim=keepdim),
                    x, _name="max")


def min(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply_op(lambda a: torch.amin(a, _dims(a, ax), keepdim=keepdim),
                    x, _name="min")


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def all(x, axis=None, keepdim=False, name=None):
    a = as_array(x).bool()
    ax = _axis(axis)
    return torch.all(a, _dims(a, ax), keepdim=keepdim) if a.dim() \
        else a.clone()


def any(x, axis=None, keepdim=False, name=None):
    a = as_array(x).bool()
    ax = _axis(axis)
    return torch.any(a, _dims(a, ax), keepdim=keepdim) if a.dim() \
        else a.clone()


def logsumexp(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply_op(lambda a: torch.logsumexp(a, _dims(a, ax),
                                              keepdim=keepdim),
                    x, _name="logsumexp")


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _axis(axis)
    return apply_op(lambda a: torch.var(a, _dims(a, ax),
                                        correction=1 if unbiased else 0,
                                        keepdim=keepdim),
                    x, _name="var")


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _axis(axis)
    return apply_op(lambda a: torch.std(a, _dims(a, ax),
                                        correction=1 if unbiased else 0,
                                        keepdim=keepdim),
                    x, _name="std")


def _sorted_middle(a, ax, keepdim, mode):
    """The median along one axis (None: all) from a sort: the mean of the
    two middle values ("avg"), or the lower one ("min")."""
    if ax is None:
        a, ax = a.reshape(-1), 0
        if keepdim:
            raise ValueError("median(axis=None, keepdim=True) is not "
                             "supported")
    s = torch.sort(a, dim=ax).values
    n = s.shape[ax]
    lo = s.select(ax, (n - 1) // 2)
    out = lo if mode == "min" else (lo + s.select(ax, n // 2)) / 2
    return out.unsqueeze(ax) if keepdim else out


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    ax = _axis(axis)
    return apply_op(lambda a: _sorted_middle(a, ax, keepdim, mode), x,
                    _name="median")


def nanmedian(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)

    def f(a):
        if ax is None:
            a = a.reshape(-1)
        d = 0 if ax is None else ax
        # the mean of the two middle non-NaN values (numpy's nanmedian)
        q = torch.nanquantile(a.double(), 0.5, dim=d,
                              keepdim=keepdim and ax is not None)
        return q.to(a.dtype)

    return apply_op(f, x, _name="nanmedian")


def _quantile(fn, a, q, ax, keepdim, interpolation):
    qv = torch.as_tensor(q, dtype=a.dtype, device=a.device)
    if ax is None:
        return fn(a.reshape(-1), qv, dim=0, keepdim=False,
                  interpolation=interpolation) if not keepdim else \
            fn(a, qv, dim=None, keepdim=True, interpolation=interpolation)
    if isinstance(ax, tuple):
        # several axes: move them last and flatten them into one
        rest = [d for d in range(a.dim()) if d not in
                [x % a.dim() for x in ax]]
        moved = a.permute(*rest, *[x % a.dim() for x in ax])
        flat = moved.reshape(*moved.shape[:len(rest)], -1)
        out = fn(flat, qv, dim=-1, keepdim=False,
                 interpolation=interpolation)
        if keepdim:
            for d in sorted(x % a.dim() for x in ax):
                out = out.unsqueeze(d + (1 if qv.dim() else 0))
        return out
    return fn(a, qv, dim=ax, keepdim=keepdim, interpolation=interpolation)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    ax = _axis(axis)
    return apply_op(lambda a: _quantile(torch.quantile, a, q, ax, keepdim,
                                        interpolation), x, _name="quantile")


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply_op(lambda a: _quantile(torch.nanquantile, a, q, ax,
                                        keepdim, "linear"), x,
                    _name="nanquantile")
