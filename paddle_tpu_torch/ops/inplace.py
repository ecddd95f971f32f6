"""Paddle's in-place `op_` family (counterpart of
`paddle_tpu/ops/inplace.py`): `add_`, `clip_`, `scatter_`, ... each the
function form's result written into its first argument, which it returns.

The reference rebinds its tensor handle to the result's tape node, so it
can write into anything, a leaf that needs grad included. The port writes
into the torch tensor (`copy_`, so views of it see the values), under
torch's rules:

- a tensor outside any graph is written in place; a result of another
  shape or dtype (`cast_`, `flatten_`, the comparisons) replaces its data;
- a tensor inside a graph (a non-leaf) takes the result through torch's
  in-place tracking: the result is computed from a copy of its old value,
  so the gradients equal the reference's; a result of another shape or
  dtype raises;
- a leaf that needs grad raises while gradients are recorded, as torch
  does (write it under `no_grad()`, or use the function form).
"""
from __future__ import annotations

import types

import torch

from . import activation, creation, logic, manipulation, math, reduction, search


def _rebind(x, fn, *args, _name="", **kwargs):
    """`fn(x, *args, **kwargs)` written into `x` by the rules above."""
    tracked = torch.is_grad_enabled() and x.requires_grad
    if tracked and x.is_leaf:
        raise RuntimeError(
            f"{_name}: a leaf tensor that requires grad cannot be written in "
            "place while gradients are recorded (torch's rule; the "
            "reference rebinds its handle): call it under paddle.no_grad(), "
            "or use the function form")
    src = x.clone() if tracked else x
    # an argument that is x itself reads the copy too (`multiply_(h, h)`)
    out = fn(src, *[src if a is x else a for a in args], **kwargs)
    if not isinstance(out, torch.Tensor):
        raise TypeError(f"{_name} source op returned {type(out)}")
    if out.shape == x.shape and out.dtype == x.dtype:
        if torch.is_grad_enabled() and out.requires_grad:
            return x.copy_(out)
        with torch.no_grad():
            return x.copy_(out)
    if tracked or (torch.is_grad_enabled() and out.requires_grad):
        raise RuntimeError(
            f"{_name}: the result's shape {tuple(out.shape)} / dtype "
            f"{out.dtype} differs from the tensor's {tuple(x.shape)} / "
            f"{x.dtype}, which torch cannot write in place inside a graph")
    x.data = out
    return x


def _make_inplace(name: str, fn):
    def op_(x, *args, **kwargs):
        return _rebind(x, fn, *args, _name=name + "_", **kwargs)

    op_.__name__ = name + "_"
    op_.__qualname__ = name + "_"
    op_.__doc__ = (f"In-place variant of ``{name}``: its result written "
                   f"into ``x``, which it returns.")
    return op_


# the base ops that get an `_` variant: the reference's lists
_UNARY = [
    "abs", "acos", "acosh", "asin", "asinh", "atan", "atanh",
    "ceil", "conj", "cos", "cosh", "digamma", "erf", "erfinv", "exp",
    "expm1", "floor", "frac", "i0", "lgamma", "log", "log10", "log1p",
    "log2", "logical_not", "logit", "neg", "reciprocal", "round", "rsqrt",
    "sigmoid", "sign", "sin", "sinh", "sqrt", "square", "tan", "tanh",
    "trunc", "bitwise_not",
]
_BINARY = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "pow", "floor_mod",
    "bitwise_and", "bitwise_or", "bitwise_xor",
    "logical_and", "logical_or", "logical_xor",
    "less_than", "less_equal", "greater_than", "greater_equal",
    "equal", "not_equal",
    "gcd", "lcm", "fmax", "fmin", "lerp", "hypot", "nextafter",
    "copysign", "ldexp",
]
_OTHER = [
    "clip", "scale", "cast", "flatten", "squeeze", "unsqueeze",
    "nan_to_num", "tril", "triu", "cumsum", "cumprod", "renorm",
    "index_add", "index_fill", "index_put", "masked_fill", "masked_scatter",
    "put_along_axis", "fill_diagonal", "lerp", "stanh", "softmax",
    "hardtanh", "leaky_relu", "relu6", "thresholded_relu",
    "apply",
]

_SOURCES = [math, reduction, manipulation, logic, search, activation,
            creation]


def _find(name):
    for mod in _SOURCES:
        fn = getattr(mod, name, None)
        if isinstance(fn, types.FunctionType):
            return fn
    return None


_generated = []
for _name in dict.fromkeys(_UNARY + _BINARY + _OTHER):
    _fn = _find(_name)
    if _fn is None:
        continue
    globals()[_name + "_"] = _make_inplace(_name, _fn)
    _generated.append(_name + "_")

__all__ = list(_generated)
