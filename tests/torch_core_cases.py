"""The harness of the core's parity tests (`tests/test_torch_core_*.py`):
one call of a public function through `paddle_tpu` (jax on the CPU) and
through `paddle_tpu_torch` (torch on the CPU, after `set_device("cpu")`) on
the same numpy inputs, outputs and, for the differentiable ones, the
inputs' gradients of sum(outputs) compared within the reference's
tolerances (`tests/op_test.py`: atol and rtol 1e-5)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch.framework import device as tdevice

ATOL = RTOL = 1e-5


@pytest.fixture
def cpu_place():
    """The port on the CPU for one test (`set_device("cpu")`), the place
    it had restored after."""
    prev = tdevice._current_place
    T.set_device("cpu")
    yield
    tdevice._current_place = prev


class Case:
    """One call: `args` (a list, or a function of a RandomState giving
    one), numpy arrays becoming tensors in both packages (lists and tuples
    of arrays lists of tensors); `grad`: hold the float inputs' gradients
    of sum(outputs); `fn`: call this instead of the package's function of
    that name (given the package); `dtype`: hold the output dtypes."""

    def __init__(self, name, args=(), kw=None, grad=True, tol=None,
                 fn=None, dtype=True, id=None):
        self.name, self.args, self.kw = name, args, kw or {}
        self.grad, self.tol, self.fn = grad, tol or (ATOL, RTOL), fn
        self.dtype = dtype
        self.id = id or name

    def __repr__(self):
        return self.id


def params(cases):
    return [pytest.param(c, id=c.id) for c in cases]


def _to(pkg, a, grad):
    if isinstance(a, np.ndarray):
        needs = grad and a.dtype.kind == "f"
        return pkg.to_tensor(a, stop_gradient=not needs)
    if isinstance(a, (list, tuple)) and a and all(
            isinstance(e, np.ndarray) for e in a):
        return type(a)(_to(pkg, e, grad) for e in a)
    return a


def _leaves(o):
    if isinstance(o, (list, tuple)):
        return [x for e in o for x in _leaves(e)]
    return [o]


def _inputs(args):
    return [x for a in args for x in _leaves(a)]


def _np_ref(o):
    return np.asarray(o)


def _np_port(o):
    if isinstance(o, torch.Tensor):
        o = o.detach()
        if o.dtype == torch.bfloat16:
            o = o.float()
        return o.numpy(force=True)
    return np.asarray(o)


def _call(pkg, case, args):
    if case.fn is not None:
        return case.fn(pkg, *args, **case.kw)
    return getattr(pkg, case.name)(*args, **case.kw)


def _ref_loss(outs):
    terms = [P.sum(o.astype("float64") if o.dtype == "float32" else o)
             for o in outs if isinstance(o, P.Tensor) and not o.stop_gradient
             and o.dtype in ("float32", "float64")]
    if not terms:
        return None
    loss = terms[0]
    for t in terms[1:]:
        loss = loss + t
    return loss


def _port_loss(outs):
    terms = [o.double().sum() for o in outs if isinstance(o, torch.Tensor)
             and o.requires_grad and o.is_floating_point()]
    return sum(terms) if terms else None


def run(case, seed=0):
    """Run `case` through both packages and hold the port to the
    reference."""
    rng = np.random.RandomState(seed)
    args = case.args(rng) if callable(case.args) else list(case.args)
    port_args = [_to(T, a, case.grad) for a in args]
    ref_args = [_to(P, a, case.grad) for a in args]
    ref = _call(P, case, ref_args)
    out = _call(T, case, port_args)
    atol, rtol = case.tol
    r_leaves, p_leaves = _leaves(ref), _leaves(out)
    assert len(r_leaves) == len(p_leaves), (len(r_leaves), len(p_leaves))
    for r, p in zip(r_leaves, p_leaves):
        rn, pn = _np_ref(r), _np_port(p)
        assert rn.shape == pn.shape, (rn.shape, pn.shape)
        if case.dtype:
            assert str(rn.dtype) == str(pn.dtype), (rn.dtype, pn.dtype)
        if rn.dtype.kind in "fc" or pn.dtype.kind in "fc":
            np.testing.assert_allclose(pn.astype(rn.dtype), rn, atol=atol,
                                       rtol=rtol, equal_nan=True)
        else:
            np.testing.assert_array_equal(pn, rn)
    if not case.grad:
        return out
    r_loss, p_loss = _ref_loss(r_leaves), _port_loss(p_leaves)
    assert (r_loss is None) == (p_loss is None)
    if r_loss is None:
        return out
    r_loss.backward()
    p_loss.backward()
    r_in = [t for t in _inputs(ref_args) if isinstance(t, P.Tensor)]
    p_in = [t for t in _inputs(port_args) if isinstance(t, torch.Tensor)]
    for r, p in zip(r_in, p_in):
        if not p.requires_grad:
            continue
        rg = np.zeros(r.shape) if r.grad is None else np.asarray(r.grad)
        pg = np.zeros(p.shape) if p.grad is None else _np_port(p.grad)
        np.testing.assert_allclose(pg, rg, atol=atol, rtol=rtol)
    return out


# input makers: f(shape) -> a function of a RandomState
def f32(*shape, lo=-2.0, hi=2.0):
    return lambda rng: rng.uniform(lo, hi, shape).astype(np.float32)


def pos(*shape, lo=0.5, hi=2.0):
    return f32(*shape, lo=lo, hi=hi)


def i64(*shape, lo=-5, hi=6):
    return lambda rng: rng.randint(lo, hi, shape).astype(np.int64)


def args(*makers):
    """A list of inputs from makers (RandomState -> value) and plain
    values."""
    return lambda rng: [m(rng) if callable(m) else m for m in makers]
