"""Elementwise and scalar math ops (counterpart of
`paddle_tpu/ops/math.py`): binary arithmetic with broadcasting, unary
math, cast, clip, the cumulative ops, lerp, addmm, the special functions.
Each is one torch expression run through `tensor.apply_op`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as _dtype
from ..tensor import Tensor, apply_op, as_array  # noqa: F401


def _binop(fn, name):
    def op(x, y, name_=None, name=None):
        return apply_op(fn, x, y, _name=name)

    op.__name__ = name
    return op


def _floor_mod(a, b):
    # numpy's sign rule (the divisor's) for both integers and floats
    return torch.remainder(a, b)


def _heaviside(a, b):
    return torch.heaviside(a, b.to(a.dtype))


def _ldexp(x, i):
    return x * torch.pow(torch.tensor(2.0, dtype=x.dtype, device=x.device),
                         i.to(torch.int32).to(x.dtype))


def _div(a, b):
    return torch.true_divide(a, b)


add = _binop(torch.add, "add")
subtract = _binop(torch.subtract, "subtract")
multiply = _binop(torch.multiply, "multiply")
divide = _binop(_div, "divide")
mod = _binop(_floor_mod, "mod")
remainder = mod
floor_mod = mod
floor_divide = _binop(lambda a, b: torch.div(a, b, rounding_mode="floor"),
                      "floor_divide")
pow = _binop(torch.pow, "pow")
maximum = _binop(torch.maximum, "maximum")
minimum = _binop(torch.minimum, "minimum")
fmax = _binop(torch.fmax, "fmax")
fmin = _binop(torch.fmin, "fmin")
atan2 = _binop(torch.atan2, "atan2")
hypot = _binop(torch.hypot, "hypot")
logaddexp = _binop(torch.logaddexp, "logaddexp")
heaviside = _binop(_heaviside, "heaviside")
copysign = _binop(torch.copysign, "copysign")
nextafter = _binop(torch.nextafter, "nextafter")
gcd = _binop(torch.gcd, "gcd")
lcm = _binop(torch.lcm, "lcm")
ldexp = _binop(_ldexp, "ldexp")

bitwise_and = _binop(torch.bitwise_and, "bitwise_and")
bitwise_or = _binop(torch.bitwise_or, "bitwise_or")
bitwise_xor = _binop(torch.bitwise_xor, "bitwise_xor")
bitwise_left_shift = _binop(torch.bitwise_left_shift, "bitwise_left_shift")
bitwise_right_shift = _binop(torch.bitwise_right_shift,
                             "bitwise_right_shift")


def bitwise_not(x, name=None):
    return apply_op(torch.bitwise_not, x, _name="bitwise_not")


def _unop(fn, name):
    def op(x, name_=None, name=None):
        return apply_op(fn, x, _name=name)

    op.__name__ = name
    return op


def _float_of(fn):
    """fn over a floating tensor: integer inputs become the default float
    dtype first, as jnp's transcendental functions make them."""
    def f(a):
        if not (a.is_floating_point() or a.is_complex()):
            from ..framework import config

            a = a.to(_dtype.to_torch_dtype(config.get_default_dtype()))
        return fn(a)

    return f


exp = _unop(torch.exp, "exp")
expm1 = _unop(torch.expm1, "expm1")
log = _unop(torch.log, "log")
log2 = _unop(torch.log2, "log2")
log10 = _unop(torch.log10, "log10")
log1p = _unop(torch.log1p, "log1p")
sqrt = _unop(torch.sqrt, "sqrt")
rsqrt = _unop(torch.rsqrt, "rsqrt")
square = _unop(torch.square, "square")
abs = _unop(torch.abs, "abs")
sign = _unop(torch.sgn, "sign")
sgn = sign
neg = _unop(torch.negative, "neg")
negative = neg
positive = _unop(torch.positive, "positive")
reciprocal = _unop(torch.reciprocal, "reciprocal")
floor = _unop(torch.floor, "floor")
ceil = _unop(torch.ceil, "ceil")
trunc = _unop(torch.trunc, "trunc")
frac = _unop(lambda a: a - torch.trunc(a), "frac")
sin = _unop(torch.sin, "sin")
cos = _unop(torch.cos, "cos")
tan = _unop(torch.tan, "tan")
asin = _unop(torch.asin, "asin")
acos = _unop(torch.acos, "acos")
atan = _unop(torch.atan, "atan")
sinh = _unop(torch.sinh, "sinh")
cosh = _unop(torch.cosh, "cosh")
tanh = _unop(torch.tanh, "tanh")
asinh = _unop(torch.asinh, "asinh")
acosh = _unop(torch.acosh, "acosh")
atanh = _unop(torch.atanh, "atanh")
erf = _unop(torch.erf, "erf")
erfinv = _unop(torch.erfinv, "erfinv")
lgamma = _unop(torch.lgamma, "lgamma")
digamma = _unop(torch.digamma, "digamma")
i0 = _unop(torch.i0, "i0")
angle = _unop(torch.angle, "angle")
conj = _unop(lambda a: torch.conj(a).resolve_conj(), "conj")
real = _unop(lambda a: torch.real(a) if a.is_complex() else a, "real")
imag = _unop(lambda a: torch.imag(a) if a.is_complex()
             else torch.zeros_like(a), "imag")
deg2rad = _unop(_float_of(torch.deg2rad), "deg2rad")
rad2deg = _unop(_float_of(torch.rad2deg), "rad2deg")
exponent = _unop(lambda a: torch.frexp(a)[1].to(a.dtype), "exponent")


def _identity(x, name=None):
    return apply_op(lambda a: a.clone(), x, _name="identity")


def round(x, decimals=0, name=None):
    return apply_op(lambda a: torch.round(a, decimals=int(decimals)), x,
                    _name="round")


def cast(x, dtype):
    dt = _dtype.to_torch_dtype(dtype)
    return apply_op(lambda a: a.to(dt), x, _name="cast")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    s = scale
    if bias_after_scale:
        out = apply_op(lambda a: a * s + bias, x, _name="scale")
    else:
        out = apply_op(lambda a: (a + bias) * s, x, _name="scale")
    if act is not None:
        from . import activation

        out = getattr(activation, act)(out)
    return out


def clip(x, min=None, max=None, name=None):
    lo = min.item() if isinstance(min, torch.Tensor) else min
    hi = max.item() if isinstance(max, torch.Tensor) else max
    return apply_op(lambda a: torch.clamp(a, lo, hi), x, _name="clip")


def lerp(x, y, weight, name=None):
    if isinstance(weight, torch.Tensor):
        return apply_op(lambda a, b, w: a + w * (b - a), x, y, weight,
                        _name="lerp")
    return apply_op(lambda a, b: a + weight * (b - a), x, y, _name="lerp")


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply_op(lambda a: scale_b * torch.tanh(scale_a * a), x,
                    _name="stanh")


def multiplex(inputs, index, name=None):
    def f(idx, *arrs):
        stacked = torch.stack(arrs, 0)
        sel = idx.reshape(1, -1, *([1] * (stacked.dim() - 2))).long()
        sel = sel.expand(1, *stacked.shape[1:])
        return torch.take_along_dim(stacked, sel, 0)[0]

    return apply_op(f, index, *inputs, _name="multiplex")


def _flat_axis(a, axis):
    return (a.reshape(-1), 0) if axis is None else (a, int(axis))


def cumsum(x, axis=None, dtype=None, name=None):
    dt = _dtype.to_torch_dtype(dtype) if dtype else None

    def f(a):
        a, ax = _flat_axis(a, axis)
        return torch.cumsum(a, ax, dtype=dt)

    return apply_op(f, x, _name="cumsum")


def cumprod(x, dim=None, dtype=None, name=None):
    dt = _dtype.to_torch_dtype(dtype) if dtype else None

    def f(a):
        a, ax = _flat_axis(a, dim)
        return torch.cumprod(a, ax, dtype=dt)

    return apply_op(f, x, _name="cumprod")


def _running_index(a, ax, vals):
    """The last index at which the running extreme `vals` was reached
    (the reference's indices)."""
    shape = [1] * a.dim()
    shape[ax] = -1
    idx = torch.arange(a.shape[ax], device=a.device).reshape(shape)
    idx = torch.where(a == vals, idx, torch.full_like(idx, -1))
    return torch.cummax(idx.expand_as(a), ax).values


def cummax(x, axis=None, dtype="int64", name=None):
    def f(a):
        a, ax = _flat_axis(a, axis)
        return torch.cummax(a, ax).values

    values = apply_op(f, x, _name="cummax")
    a, ax = _flat_axis(as_array(x), axis)
    idx = _running_index(a, ax, values.detach())
    return values, idx.to(_dtype.to_torch_dtype(dtype))


def cummin(x, axis=None, dtype="int64", name=None):
    vals, idx = cummax(neg(x), axis=axis, dtype=dtype)
    return neg(vals), idx


def logcumsumexp(x, axis=None, dtype=None, name=None):
    def f(a):
        a, ax = _flat_axis(a, axis)
        return torch.logcumsumexp(a, ax)

    return apply_op(f, x, _name="logcumsumexp")


def isnan(x, name=None):
    return torch.isnan(as_array(x))


def isinf(x, name=None):
    return torch.isinf(as_array(x))


def isfinite(x, name=None):
    return torch.isfinite(as_array(x))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply_op(lambda a: torch.nan_to_num(a, nan, posinf, neginf), x,
                    _name="nan_to_num")


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply_op(lambda i, a, b: beta * i + alpha * (a @ b), input, x, y,
                    _name="addmm")


def inner(x, y, name=None):
    return apply_op(torch.inner, x, y, _name="inner")


def outer(x, y, name=None):
    return apply_op(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)),
                    x, y, _name="outer")


def kron(x, y, name=None):
    return apply_op(torch.kron, x, y, _name="kron")


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op(lambda a: torch.diagonal(a, offset, axis1, axis2).sum(-1),
                    x, _name="trace")


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op(lambda a: torch.diagonal(a, offset, axis1, axis2), x,
                    _name="diagonal")


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    extra = [t for t in (prepend, append) if t is not None]

    def f(a, *rest):
        pre = rest[0] if prepend is not None else None
        app = rest[-1] if append is not None else None
        return torch.diff(a, n, axis, pre, app)

    return apply_op(f, x, *extra, _name="diff")


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply_op(lambda a: torch.rot90(a, k, list(axes)), x,
                    _name="rot90")


def take(x, index, mode="raise", name=None):
    def f(a, idx):
        flat, n = a.reshape(-1), a.numel()
        idx = idx.long()
        if mode == "wrap":
            idx = torch.remainder(idx, n)
        elif mode == "clip":
            idx = torch.clamp(idx, 0, n - 1)
        else:
            idx = torch.where(idx < 0, idx + n, idx)
        return flat[idx]

    return apply_op(f, x, index, _name="take")


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def increment(x, value=1.0, name=None):
    with torch.no_grad():
        x.add_(value)
    return x


def count_nonzero(x, axis=None, keepdim=False, name=None):
    a = as_array(x)
    out = (a != 0).sum(dim=axis, keepdim=keepdim, dtype=torch.int64)
    return out


def gammaln(x, name=None):
    return lgamma(x)


def polygamma(x, n, name=None):
    return apply_op(lambda a: torch.polygamma(int(n), a), x,
                    _name="polygamma")


def igamma(x, a, name=None):
    # the reference's igamma(x, a) is gammaincc(x, a): x takes the shape
    # parameter's place
    return apply_op(torch.special.gammaincc, x, a, _name="igamma")


def igammac(x, a, name=None):
    return apply_op(torch.special.gammainc, x, a, _name="igammac")


i0e = _unop(torch.special.i0e, "i0e")
i1 = _unop(torch.special.i1, "i1")
i1e = _unop(torch.special.i1e, "i1e")
sinc = _unop(torch.sinc, "sinc")
signbit = _unop(torch.signbit, "signbit")
isneginf = _unop(torch.isneginf, "isneginf")
isposinf = _unop(torch.isposinf, "isposinf")
gammainc = _binop(torch.special.gammainc, "gammainc")
gammaincc = _binop(torch.special.gammaincc, "gammaincc")


def logit(x, eps=None, name=None):
    return apply_op(lambda a: torch.logit(a, eps), x, _name="logit")


def multigammaln(x, p, name=None):
    return apply_op(lambda a: torch.special.multigammaln(a, p), x,
                    _name="multigammaln")


def frexp(x, name=None):
    def f(a):
        m, e = torch.frexp(a)
        return m, e.to(a.dtype)

    return apply_op(f, x, _name="frexp")


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return apply_op(lambda y_, x_: torch.trapezoid(y_, x_, dim=axis), y,
                        x, _name="trapezoid")
    step = 1.0 if dx is None else dx
    return apply_op(lambda y_: torch.trapezoid(y_, dx=step, dim=axis), y,
                    _name="trapezoid")


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return apply_op(
            lambda y_, x_: torch.cumulative_trapezoid(y_, x_, dim=axis), y, x,
            _name="cumulative_trapezoid")
    step = 1.0 if dx is None else dx
    return apply_op(
        lambda y_: torch.cumulative_trapezoid(y_, dx=step, dim=axis), y,
        _name="cumulative_trapezoid")


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along `axis` scaled to at most `max_norm` in p-norm (the
    reference's expression, with its 1e-7 in the divisor)."""
    def f(a):
        ax = axis % a.dim()
        red = tuple(i for i in range(a.dim()) if i != ax)
        norms = torch.sum(torch.abs(a) ** p, dim=red, keepdim=True) ** (
            1.0 / p)
        factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                             torch.ones_like(norms))
        return a * factor

    return apply_op(f, x, _name="renorm")


def add_n(inputs, name=None):
    """The sum of a list of tensors (paddle.add_n)."""
    if isinstance(inputs, (list, tuple)):
        out = inputs[0]
        for t in inputs[1:]:
            out = add(out, t)
        return out
    return inputs


def rank(x, name=None):
    a = as_array(x)
    return torch.tensor(a.dim(), dtype=torch.int64, device=a.device)


def inverse(x, name=None):
    from .linalg import inv

    return inv(x)

