"""The core's in-place `op_` family (`paddle_tpu_torch/ops/inplace.py`)
and the indexing functions (`ops/indexing.py`) against the reference's.

Every generated `op_` writes its function form's result into its first
argument and returns it: held against the reference's on the same inputs
(the values, and that the returned tensor is the argument). Where the
reference rebinds a leaf that needs grad, torch refuses to write into one:
the port raises, naming the way out, and the gradients of an in-place op
on a non-leaf equal the reference's (the reference's own cases of
tests/test_autograd.py: `add_`, `__setitem__`)."""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch.ops import inplace as tinplace
from torch_core_cases import cpu_place  # noqa: F401

R = np.random.RandomState(0)
X = R.uniform(0.2, 0.9, (3, 4)).astype(np.float32)
Y = R.uniform(0.2, 0.9, (3, 4)).astype(np.float32)
XI = R.randint(1, 9, (3, 4)).astype(np.int64)
YI = R.randint(1, 9, (3, 4)).astype(np.int64)
BOOL = R.rand(3, 4) > 0.5

# the extra arguments of the ops past the first (numpy arrays become
# tensors of both packages)
EXTRA = {
    "clip": (0.3, 0.6), "scale": (2.0, 0.5), "cast": ("float64",),
    "flatten": (), "squeeze": (), "unsqueeze": (0,), "nan_to_num": (),
    "tril": (), "triu": (1,), "cumsum": (1,), "cumprod": (1,),
    "renorm": (2.0, 0, 1.0), "index_add": (np.array([0, 2]), 0,
                                           Y[:2].copy()),
    "index_fill": (np.array([1]), 1, -1.0),
    "index_put": ((np.array([0, 1]), np.array([2, 3])),
                  np.array([5.0, 6.0], np.float32)),
    "masked_fill": (BOOL, 0.5), "masked_scatter": (BOOL, Y.copy()),
    "put_along_axis": (np.array([[0], [1], [2]]), 9.0, 1),
    "fill_diagonal": (3.0,), "lerp": (Y.copy(), 0.25), "stanh": (),
    "softmax": (), "hardtanh": (), "leaky_relu": (), "relu6": (),
    "thresholded_relu": (0.5,), "apply": (None,),
}
INT_OPS = {"floor_divide", "mod", "remainder", "floor_mod", "bitwise_and",
           "bitwise_or", "bitwise_xor", "gcd", "lcm", "bitwise_not"}
BOOL_OPS = {"logical_and", "logical_or", "logical_xor", "logical_not"}


def _inputs(base):
    if base in INT_OPS:
        return XI.copy(), YI.copy()
    if base in BOOL_OPS:
        return BOOL.copy(), ~BOOL
    if base == "ldexp":
        return X.copy(), YI.copy()
    return X.copy(), Y.copy()


def _conv(pkg, a):
    if isinstance(a, np.ndarray):
        return pkg.to_tensor(a)
    if isinstance(a, tuple) and a and isinstance(a[0], np.ndarray):
        return tuple(pkg.to_tensor(e) for e in a)
    return a


@pytest.mark.parametrize("name", tinplace.__all__)
def test_inplace_op_writes_the_reference_s_result(name, cpu_place):
    base = name[:-1]
    x, y = _inputs(base)
    if base in EXTRA:
        extra = list(EXTRA[base])
    elif base in tinplace._UNARY:
        extra = []
    else:
        extra = [y]
    if base == "apply":
        r_extra, p_extra = [P.exp], [T.exp]
    else:
        r_extra = [_conv(P, a) for a in extra]
        p_extra = [_conv(T, a) for a in extra]
    rx, px = P.to_tensor(x), T.to_tensor(x)
    r_out = getattr(P, name)(rx, *r_extra)
    p_out = getattr(T, name)(px, *p_extra)
    assert p_out is px and r_out is rx
    want, got = np.asarray(rx), px.numpy()
    assert got.shape == want.shape and str(got.dtype) == str(want.dtype)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_a_view_sees_the_write(cpu_place):
    x = T.to_tensor(X.copy())
    v = x[1]
    T.add_(x, T.ones([3, 4]))
    np.testing.assert_allclose(v.numpy(), X[1] + 1, rtol=1e-6)


def test_a_leaf_that_needs_grad_raises_where_the_reference_rebinds(
        cpu_place):
    """The reference writes into a leaf that needs grad and its gradient
    lands on the leaf as the gradient of its old value; torch refuses the
    write, so the port raises, and under no_grad it writes."""
    rx = P.to_tensor(X.copy(), stop_gradient=False)
    P.multiply_(rx, P.to_tensor(Y))
    P.sum(rx).backward()
    np.testing.assert_allclose(np.asarray(rx.grad), Y, rtol=1e-6)
    px = T.to_tensor(X.copy(), stop_gradient=False)
    with pytest.raises(RuntimeError, match="leaf tensor that requires grad"):
        T.multiply_(px, T.to_tensor(Y))
    with T.no_grad():
        T.multiply_(px, T.to_tensor(Y))
    np.testing.assert_allclose(px.detach().numpy(), X * Y, rtol=1e-6)


def test_an_inplace_op_on_a_non_leaf_gives_the_reference_s_gradients(
        cpu_place):
    """tests/test_autograd.py::test_add_ through both packages, with a
    product (which saves its inputs) after the write."""
    grads = []
    for pkg in (P, T):
        x = pkg.to_tensor(X.copy(), stop_gradient=False)
        w = pkg.to_tensor(Y.copy(), stop_gradient=False)
        h = pkg.multiply(x, w)
        pkg.add_(h, pkg.to_tensor(Y))
        pkg.multiply_(h, h)
        pkg.sum(h).backward()
        grads.append([np.asarray(x.grad) if pkg is P else x.grad.numpy(),
                      np.asarray(w.grad) if pkg is P else w.grad.numpy()])
    for r, p in zip(*grads):
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-6)


def test_inplace_in_a_graph_refuses_a_new_shape(cpu_place):
    x = T.to_tensor(X.copy(), stop_gradient=False) * 1
    with pytest.raises(RuntimeError, match="differs"):
        T.flatten_(x)
    y = T.to_tensor(X.copy())
    T.flatten_(y)
    T.cast_(y, "float64")
    assert y.shape == (12,) and y.dtype == torch.float64


def test_setitem_and_getitem_match_the_reference(cpu_place):
    """indexing.getitem / setitem_ (tests/test_autograd.py's setitem
    case): values and the gradients through the write."""
    from paddle_tpu.ops import indexing as jidx
    from paddle_tpu_torch.ops import indexing as tidx

    outs = []
    for pkg, ix in ((P, jidx), (T, tidx)):
        x = pkg.to_tensor(X.copy(), stop_gradient=False)
        h = pkg.multiply(x, 2.0)
        ix.setitem_(h, (slice(0, 2), [1, 3]),
                    pkg.to_tensor(np.array([7.0, 8.0], np.float32)))
        g = ix.getitem(h, ([0, 2], slice(None, None, 2)))
        pkg.sum(pkg.multiply(g, g)).backward()
        outs.append([np.asarray(g.detach() if pkg is T else g),
                     np.asarray(x.grad)])
    for r, p in zip(*outs):
        np.testing.assert_allclose(p, r, rtol=1e-6)


def test_increment_and_where_write_in_place(cpu_place):
    x = T.to_tensor(np.array([1.0], np.float32))
    assert T.increment(x, 2.0) is x and float(x) == 3.0
    a = T.to_tensor(X.copy())
    out = T.where_(T.to_tensor(BOOL), a, T.to_tensor(Y))
    assert out is a
    np.testing.assert_allclose(a.numpy(), np.where(BOOL, X, Y))
