"""Comparison and logic ops (counterpart of `paddle_tpu/ops/logic.py`).
Their outputs are bool and take no gradient."""
from __future__ import annotations

import torch

from ..tensor import Tensor, apply_op, as_array  # noqa: F401


def _cmp(fn, opname):
    def op(x, y, name_=None, name=None):
        with torch.no_grad():
            return apply_op(fn, x, y, _name=opname)

    op.__name__ = opname
    return op


equal = _cmp(torch.eq, "equal")
not_equal = _cmp(torch.ne, "not_equal")
greater_than = _cmp(torch.gt, "greater_than")
greater_equal = _cmp(torch.ge, "greater_equal")
less_than = _cmp(torch.lt, "less_than")
less_equal = _cmp(torch.le, "less_equal")


def _logical(fn, opname):
    def op(x, y=None, out=None, name=None):
        with torch.no_grad():
            if y is None:
                return apply_op(fn, x, _name=opname)
            return apply_op(fn, x, y, _name=opname)

    op.__name__ = opname
    return op


def equal_all(x, y, name=None):
    a, b = as_array(x), as_array(y)
    if a.shape != b.shape:
        return torch.tensor(False, device=a.device)
    return torch.all(a == b)


logical_and = _logical(torch.logical_and, "logical_and")
logical_or = _logical(torch.logical_or, "logical_or")
logical_xor = _logical(torch.logical_xor, "logical_xor")


def logical_not(x, out=None, name=None):
    with torch.no_grad():
        return apply_op(torch.logical_not, x, _name="logical_not")


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a = as_array(x)
    return torch.tensor(torch.allclose(a, as_array(y, a.device), float(rtol),
                                       float(atol), equal_nan),
                        device=a.device)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a = as_array(x)
    return torch.isclose(a, as_array(y, a.device), float(rtol), float(atol),
                         equal_nan)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        from . import search

        return search.nonzero(condition, as_tuple=True)
    return apply_op(lambda c, a, b: torch.where(c.bool(), a, b), condition,
                    x, y, _name="where")


def where_(condition, x, y, name=None):
    from .inplace import _rebind

    return _rebind(x, lambda x_: where(condition, x_, y), _name="where_")


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def is_empty(x, name=None):
    a = as_array(x)
    return torch.tensor(a.numel() == 0, device=a.device)


def isreal(x, name=None):
    a = as_array(x)
    if a.is_complex():
        return a.imag == 0
    return torch.ones(a.shape, dtype=torch.bool, device=a.device)


def in1d(x, test, name=None):
    a = as_array(x)
    return torch.isin(a, as_array(test, a.device))


isin = in1d


def is_complex(x, name=None):
    return as_array(x).is_complex()


def is_floating_point(x, name=None):
    return as_array(x).is_floating_point()


def is_integer(x, name=None):
    a = as_array(x)
    return not (a.is_floating_point() or a.is_complex()
                or a.dtype == torch.bool)
