"""Activations (counterpart of `paddle_tpu/ops/activation.py`).

`gelu(approximate=False)` is the exact erf form; `softmax(dtype=)` casts
the input first; the random ones (`rrelu` in training, `gumbel_softmax`)
draw from the port's stream (`framework.random`), other numbers than the
reference's `jax.random` for one seed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ..framework import dtype as _dtype
from ..tensor import Tensor, apply_op, as_array  # noqa: F401


def relu(x, name=None):
    return apply_op(torch.relu, x, _name="relu")


def relu_(x, name=None):
    from .inplace import _rebind

    return _rebind(x, relu, _name="relu_")


def relu6(x, name=None):
    return apply_op(TF.relu6, x, _name="relu6")


def gelu(x, approximate=False, name=None):
    return apply_op(lambda a: TF.gelu(a, approximate="tanh" if approximate
                                      else "none"), x, _name="gelu")


def sigmoid(x, name=None):
    return apply_op(torch.sigmoid, x, _name="sigmoid")


def log_sigmoid(x, name=None):
    return apply_op(TF.logsigmoid, x, _name="log_sigmoid")


def tanh(x, name=None):
    return apply_op(torch.tanh, x, _name="tanh")


def tanhshrink(x, name=None):
    return apply_op(lambda a: a - torch.tanh(a), x, _name="tanhshrink")


def hardshrink(x, threshold=0.5, name=None):
    return apply_op(lambda a: torch.where(torch.abs(a) > threshold, a,
                                          torch.zeros_like(a)), x,
                    _name="hardshrink")


def softshrink(x, threshold=0.5, name=None):
    return apply_op(lambda a: torch.where(
        a > threshold, a - threshold,
        torch.where(a < -threshold, a + threshold, torch.zeros_like(a))), x,
        _name="softshrink")


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply_op(lambda a: torch.clamp(a, min, max), x, _name="hardtanh")


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return apply_op(lambda a: torch.clamp(a * slope + offset, 0.0, 1.0), x,
                    _name="hardsigmoid")


def hardswish(x, name=None):
    return apply_op(lambda a: a * torch.clamp(a + 3.0, 0.0, 6.0) / 6.0, x,
                    _name="hardswish")


def elu(x, alpha=1.0, name=None):
    return apply_op(lambda a: TF.elu(a, alpha), x, _name="elu")


def celu(x, alpha=1.0, name=None):
    return apply_op(lambda a: TF.celu(a, alpha), x, _name="celu")


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply_op(lambda a: scale * torch.where(
        a > 0, a, alpha * torch.expm1(a)), x, _name="selu")


def silu(x, name=None):
    return apply_op(TF.silu, x, _name="silu")


def swish(x, name=None):
    return silu(x)


def mish(x, name=None):
    return apply_op(lambda a: a * torch.tanh(TF.softplus(a)), x,
                    _name="mish")


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply_op(lambda a: TF.leaky_relu(a, negative_slope), x,
                    _name="leaky_relu")


def prelu(x, weight, data_format="NCHW", name=None):
    def f(a, w):
        if w.numel() == 1:
            return torch.where(a >= 0, a, w.reshape(()) * a)
        shape = [1, -1] + [1] * (a.dim() - 2) if data_format == "NCHW" \
            else [1] * (a.dim() - 1) + [-1]
        return torch.where(a >= 0, a, w.reshape(shape) * a)

    return apply_op(f, x, weight, _name="prelu")


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None):
    if training:
        from ..framework import random as _random

        def f(a):
            g = _random.generator(a.device)
            r = torch.empty_like(a).uniform_(lower, upper, generator=g)
            return torch.where(a >= 0, a, r * a)

        return apply_op(f, x, _name="rrelu")
    mid = (lower + upper) / 2.0
    return apply_op(lambda a: torch.where(a >= 0, a, mid * a), x,
                    _name="rrelu")


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply_op(lambda a: torch.where(
        a * beta > threshold, a, (1.0 / beta) * TF.softplus(beta * a)), x,
        _name="softplus")


def softsign(x, name=None):
    return apply_op(TF.softsign, x, _name="softsign")


def softmax(x, axis=-1, dtype=None, name=None):
    dt = _dtype.to_torch_dtype(dtype) if dtype else None
    return apply_op(lambda a: torch.softmax(a if dt is None else a.to(dt),
                                            int(axis)), x, _name="softmax")


softmax_ = softmax


def log_softmax(x, axis=-1, dtype=None, name=None):
    dt = _dtype.to_torch_dtype(dtype) if dtype else None
    return apply_op(lambda a: torch.log_softmax(
        a if dt is None else a.to(dt), int(axis)), x, _name="log_softmax")


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    from ..framework import random as _random

    def f(a):
        u = torch.rand(a.shape, dtype=a.dtype, device=a.device,
                       generator=_random.generator(a.device))
        g = -torch.log(-torch.log(u.clamp_min(torch.finfo(a.dtype).tiny)))
        y = torch.softmax((a + g) / temperature, axis)
        if hard:
            idx = torch.argmax(y, axis, keepdim=True)
            y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
            y = y_hard - y.detach() + y
        return y

    return apply_op(f, x, _name="gumbel_softmax")


def maxout(x, groups, axis=1, name=None):
    def f(a):
        ax = int(axis) % a.dim()
        shape = list(a.shape)
        shape[ax:ax + 1] = [groups, a.shape[ax] // groups]
        return torch.amax(a.reshape(shape), ax)

    return apply_op(f, x, _name="maxout")


def glu(x, axis=-1, name=None):
    return apply_op(lambda a: TF.glu(a, int(axis)), x, _name="glu")


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return apply_op(lambda a: torch.where(a > threshold, a,
                                          torch.full_like(a, value)), x,
                    _name="thresholded_relu")
