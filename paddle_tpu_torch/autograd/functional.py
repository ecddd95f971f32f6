"""Functional higher-order autograd (counterpart of
`paddle_tpu/autograd/functional.py`): `vjp`, `jvp`, `jacobian` and
`hessian` of a function of tensors, over `torch.autograd.functional`
(torch's autograd, so the function may call any op of the port)."""
from __future__ import annotations

import torch
from torch.autograd import functional as _F


def _unpack(xs):
    single = not isinstance(xs, (list, tuple))
    return single, tuple([xs] if single else xs)


def _tuple_fn(func):
    def f(*xs):
        out = func(*xs)
        return tuple(out) if isinstance(out, list) else out

    return f


def _outs(out):
    return list(out) if isinstance(out, tuple) else out


def vjp(func, xs, v=None):
    """(outputs, vjp) of `func` at `xs` against the cotangent `v` (ones by
    default): a tensor for a single input, else a list."""
    single, arrs = _unpack(xs)
    if v is not None and isinstance(v, list):
        v = tuple(v)
    if v is None:
        with torch.no_grad():
            out = _tuple_fn(func)(*arrs)
        v = tuple(torch.ones_like(o) for o in out) \
            if isinstance(out, tuple) else torch.ones_like(out)
    out, gs = _F.vjp(_tuple_fn(func), arrs, v)
    return _outs(out), gs[0] if single else list(gs)


def jvp(func, xs, v=None):
    """(outputs, jvp) of `func` at `xs` along the tangent `v` (ones by
    default)."""
    single, arrs = _unpack(xs)
    if v is None:
        v = tuple(torch.ones_like(a) for a in arrs)
    elif isinstance(v, (list, tuple)):
        v = tuple(v)
    else:
        v = (v,)
    out, touts = _F.jvp(_tuple_fn(func), arrs, v)
    return _outs(out), _outs(touts)


def jacobian(func, xs, create_graph=False, allow_unused=False):
    """d func(xs) / d xs: one tensor [*out_shape, *in_shape] for a single
    input and output; a list over the inputs; a list over the outputs of
    such for a function with several outputs."""
    single, arrs = _unpack(xs)
    jac = _F.jacobian(_tuple_fn(func), arrs, create_graph=create_graph,
                      strict=False)
    if isinstance(jac[0], tuple):  # several outputs: [out][in]
        rows = [list(per_out) for per_out in jac]
        return [r[0] for r in rows] if single else rows
    return jac[0] if single else list(jac)


def hessian(func, xs, create_graph=False, allow_unused=False):
    """d^2 func(xs) / d xs^2 of a function with a scalar output: a tensor
    for a single input, else a nested list [i][j]."""
    single, arrs = _unpack(xs)

    def scalar(*a):
        out = func(*a)
        if isinstance(out, (tuple, list)):
            out = out[0]
        if out.dim() != 0:
            raise ValueError("hessian() requires a scalar-output func")
        return out

    hess = _F.hessian(scalar, arrs, create_graph=create_graph, strict=False)
    if single:
        return hess[0][0]
    return [list(row) for row in hess]
