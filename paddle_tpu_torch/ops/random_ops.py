"""Random sampling (counterpart of `paddle_tpu/ops/random_ops.py`): rand,
randn, randint, randperm, uniform, normal, bernoulli, multinomial, poisson,
the in-place fills.

Every draw comes from the port's stream (`framework.random`): a generator
on the output's device seeded by one draw of the global stream, so
`seed(s)` repeats them. The numbers differ from the reference's
`jax.random` for one seed (ROADMAP, deliberate differences). A new tensor
lands where `resolve_device(None)` says; an in-place fill keeps its
tensor's device.
"""
from __future__ import annotations

import torch

from ..framework import dtype as _dtype
from ..framework import random as _random
from ..framework.device import resolve_device
from ..tensor import Tensor, as_array  # noqa: F401
from .creation import _resolve_dtype, _shape_list


def _gen(device):
    return _random.generator(device)


def rand(shape, dtype=None, name=None):
    dev = resolve_device(None)
    return torch.rand(_shape_list(shape), dtype=_resolve_dtype(dtype),
                      device=dev, generator=_gen(dev))


def randn(shape, dtype=None, name=None):
    dev = resolve_device(None)
    return torch.randn(_shape_list(shape), dtype=_resolve_dtype(dtype),
                       device=dev, generator=_gen(dev))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    """U[min, max); a nonzero `seed` draws from a generator of its own."""
    dev = resolve_device(None)
    g = torch.Generator(dev).manual_seed(int(seed)) if seed else _gen(dev)
    out = torch.empty(_shape_list(shape), dtype=_resolve_dtype(dtype),
                      device=dev)
    return out.uniform_(float(min), float(max), generator=g)


def _fill(x, draw):
    with torch.no_grad():
        x.copy_(draw)
    return x


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    g = torch.Generator(x.device).manual_seed(int(seed)) if seed \
        else _gen(x.device)
    return _fill(x, torch.empty_like(x).uniform_(float(min), float(max),
                                                 generator=g))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    dev = next((t.device for t in (mean, std)
                if isinstance(t, torch.Tensor)), None) or \
        resolve_device(None)
    dt = _resolve_dtype(None)
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        shp = torch.broadcast_shapes(
            *[t.shape for t in (mean, std) if isinstance(t, torch.Tensor)])
    else:
        shp = _shape_list(shape) if shape is not None else []
    z = torch.randn(shp, dtype=dt, device=dev, generator=_gen(dev))
    return mean + std * z


def normal_(x, mean=0.0, std=1.0, name=None):
    z = torch.randn(x.shape, dtype=x.dtype, device=x.device,
                    generator=_gen(x.device))
    return _fill(x, mean + std * z)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = resolve_device(None)
    return torch.randint(int(low), int(high), _shape_list(shape),
                         dtype=_dtype.to_torch_dtype(dtype), device=dev,
                         generator=_gen(dev))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    return randint(low, high, list(x.shape), dtype or x.dtype)


def randperm(n, dtype="int64", name=None):
    dev = resolve_device(None)
    return torch.randperm(int(n), dtype=_dtype.to_torch_dtype(dtype),
                          device=dev, generator=_gen(dev))


def bernoulli(x, name=None):
    a = as_array(x)
    return torch.bernoulli(a, generator=_gen(a.device))


def bernoulli_(x, p=0.5, name=None):
    return _fill(x, torch.bernoulli(torch.full_like(x, p, dtype=torch.float32),
                                    generator=_gen(x.device)))


def poisson(x, name=None):
    a = as_array(x)
    return torch.poisson(a, generator=_gen(a.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    a = as_array(x)
    return torch.multinomial(a, int(num_samples), replacement,
                             generator=_gen(a.device))


def exponential_(x, lam=1.0, name=None):
    return _fill(x, torch.empty_like(x).exponential_(
        lam, generator=_gen(x.device)))


def binomial(count, prob, name=None):
    c = as_array(count)
    p = as_array(prob, c.device)
    c, p = torch.broadcast_tensors(c.to(p.dtype), p)
    return torch.binomial(c, p, generator=_gen(c.device)).to(torch.int64)


def cauchy_(x, loc=0, scale=1, name=None):
    return _fill(x, torch.empty_like(x).cauchy_(
        loc, scale, generator=_gen(x.device)))


def geometric_(x, probs, name=None):
    # the reference's draw: ceil(log1p(-u) / log1p(-p)), u ~ U[0, 1)
    u = torch.rand(x.shape, dtype=x.dtype, device=x.device,
                   generator=_gen(x.device))
    probs = torch.as_tensor(probs, dtype=x.dtype, device=x.device)
    return _fill(x, torch.ceil(torch.log1p(-u) / torch.log1p(-probs)))


def log_normal_(x, mean=1.0, std=2.0, name=None):
    z = torch.randn(x.shape, dtype=x.dtype, device=x.device,
                    generator=_gen(x.device))
    return _fill(x, torch.exp(mean + std * z))


def standard_gamma(x, name=None):
    """Gamma(alpha=x, scale=1) draws, elementwise."""
    a = as_array(x)
    return torch._standard_gamma(a, generator=_gen(a.device))
