"""Tensor creation ops (counterpart of `paddle_tpu/ops/creation.py`).

A new tensor lands where `framework.device.resolve_device(None)` says (the
place `set_device` chose, else the current CUDA device; no CUDA: it
raises); an op over a tensor keeps that tensor's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import config as _config
from ..framework import dtype as _dtype
from ..framework.device import resolve_device
from ..tensor import apply_op, as_array, to_tensor  # noqa: F401


def _resolve_dtype(dtype, default=None):
    return _dtype.to_torch_dtype(
        dtype if dtype is not None else default or
        _config.get_default_dtype())


def _shape_list(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        shape = [int(shape)]
    return [int(s.item()) if isinstance(s, torch.Tensor) else int(s)
            for s in shape]


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape_list(shape), dtype=_resolve_dtype(dtype),
                       device=resolve_device(None))


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape_list(shape), dtype=_resolve_dtype(dtype),
                      device=resolve_device(None))


def full(shape, fill_value, dtype=None, name=None):
    fill_value = _scalar(fill_value)
    if dtype is None:
        # the reference's rule: a bool fill is bool, any other the default
        # float dtype
        dtype = "bool" if isinstance(fill_value, bool) else None
    return torch.full(_shape_list(shape), fill_value,
                      dtype=_resolve_dtype(dtype),
                      device=resolve_device(None))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype=dtype)


def _like(x, dtype):
    a = as_array(x)
    return a, _dtype.to_torch_dtype(dtype) if dtype else a.dtype


def zeros_like(x, dtype=None, name=None):
    a, dt = _like(x, dtype)
    return torch.zeros(a.shape, dtype=dt, device=a.device)


def ones_like(x, dtype=None, name=None):
    a, dt = _like(x, dtype)
    return torch.ones(a.shape, dtype=dt, device=a.device)


def full_like(x, fill_value, dtype=None, name=None):
    a, dt = _like(x, dtype)
    return torch.full(a.shape, _scalar(fill_value), dtype=dt,
                      device=a.device)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype=dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    for v in (start, end, step):
        if isinstance(v, torch.Tensor):
            raise TypeError("arange with Tensor args: pass python scalars")
    if end is None:
        start, end = 0, start
    if dtype is None:
        ints = all(isinstance(v, (int, np.integer))
                   for v in (start, end, step))
        dtype = "int64" if ints else _config.get_default_dtype()
    dt = _dtype.to_torch_dtype(dtype)
    dev = resolve_device(None)
    if dt.is_floating_point:
        # the reference's count (numpy's), each element start + i * step
        # in float64 before the cast
        n = int(np.ceil((end - start) / step))
        return (start + torch.arange(max(n, 0), dtype=torch.float64,
                                     device=dev) * step).to(dt)
    return torch.arange(start, end, step, dtype=dt, device=dev)


def linspace(start, stop, num, dtype=None, name=None):
    start, stop, num = _scalar(start), _scalar(stop), int(_scalar(num))
    return torch.linspace(start, stop, num, dtype=torch.float64,
                          device=resolve_device(None)).to(
        _resolve_dtype(dtype))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(start, stop, int(num), base=base,
                          dtype=torch.float64,
                          device=resolve_device(None)).to(
        _resolve_dtype(dtype))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return torch.eye(n, m, dtype=_resolve_dtype(dtype),
                     device=resolve_device(None))


def tril(x, diagonal=0, name=None):
    return apply_op(lambda a: torch.tril(a, int(diagonal)), x, _name="tril")


def triu(x, diagonal=0, name=None):
    return apply_op(lambda a: torch.triu(a, int(diagonal)), x, _name="triu")


def tril_indices(row, col, offset=0, dtype="int64"):
    return torch.tril_indices(row, col, offset,
                              dtype=_dtype.to_torch_dtype(dtype),
                              device=resolve_device(None))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = col if col is not None else row
    return torch.triu_indices(row, col, offset,
                              dtype=_dtype.to_torch_dtype(dtype),
                              device=resolve_device(None))


def diag(x, offset=0, padding_value=0, name=None):
    def f(a):
        out = torch.diag(a, int(offset))
        if a.dim() == 1 and padding_value != 0:
            mask = torch.diag(torch.ones_like(a, dtype=torch.bool),
                              int(offset))
            out = torch.where(mask, out, torch.full_like(out, padding_value))
        return out

    return apply_op(f, x, _name="diag")


def diagflat(x, offset=0, name=None):
    return apply_op(lambda a: torch.diagflat(a, int(offset)), x,
                    _name="diagflat")


def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    """x's last axis (n) on a diagonal of new [n, n + |offset|] trailing
    axes, the reference's layout whatever dim1 and dim2 say (a negative
    offset's rows past n are dropped, as its scatter drops them)."""
    def f(a):
        n, k = a.shape[-1], abs(int(offset))
        out = a.new_zeros(a.shape + (n + k,))
        i = torch.arange(n, device=a.device)
        if offset >= 0:
            out[..., i, i + k] = a
        else:
            keep = i + k < n
            out[..., i[keep] + k, i[keep]] = a[..., keep]
        return out

    return apply_op(f, x, _name="diag_embed")


def meshgrid(*args, **kwargs):
    tensors = args[0] if len(args) == 1 and isinstance(
        args[0], (list, tuple)) else args
    return list(torch.meshgrid(*[as_array(t) for t in tensors],
                               indexing="ij"))


def assign(x, output=None):
    """A copy of `x`; with `output`, written into it (its dtype kept)."""
    data = as_array(x, None if output is None else output.device)
    if output is not None:
        with torch.no_grad():
            output.copy_(data)
        return output
    return data.clone()


def clone(x, name=None):
    from . import math as _math

    return _math._identity(x)


def complex(real, imag, name=None):
    return apply_op(torch.complex, real, imag, _name="complex")


def polar(abs_t, angle, name=None):
    return apply_op(torch.polar, abs_t, angle, _name="polar")


def one_hot(x, num_classes, name=None):
    a = as_array(x)
    return torch.nn.functional.one_hot(a.long(), int(num_classes)).to(
        _resolve_dtype(None))


def vander(x, n=None, increasing=False, name=None):
    """Vandermonde matrix (paddle.vander)."""
    return apply_op(lambda a: torch.linalg.vander(
        a, N=a.shape[0] if n is None else int(n)) if increasing
        else torch.linalg.vander(a, N=a.shape[0] if n is None else int(n))
        .flip(-1), x, _name="vander")
