"""RMSNorm: the port's `F.rms_norm` against the JAX package's on the CPU,
for every input the reference takes.

The same numpy inputs, made from a seed, go through
`paddle_tpu.nn.functional.rms_norm` (its Pallas kernel in interpret mode
where its `supports` allows: rows a multiple of its 256-row block, columns
a multiple of 128 up to 8192, a weight; its fused XLA expression otherwise)
and through `paddle_tpu_torch.nn.functional.rms_norm` (the plain versions
on the CPU). Covered: no weight, `weight=None` and `name=None`; float16;
a float32 weight under bfloat16 and float16 x; 6, 130 and 20000 columns;
2500 rows; and the gradients against `jax.vjp` of the reference, with and
without a weight.

Tolerance: float32 1e-5 abs (both sides compute the same f32 arithmetic in
another order; dw, a sum over the rows, 1e-4). bfloat16 and float16: one
rounding, |got - want| at most one unit in the last place (ulp) of the
reference's value in that dtype: both sides compute in f32 and round once,
so they differ only where their f32 values straddle a rounding boundary.
One exception, the reference's dx on its XLA path: its expression converts
x to f32 twice (once for the variance, once for the scaling), so its vjp
rounds each branch's cotangent to x's dtype before adding them,
dx = round(round(t1) + round(t2)) with t1 = rstd * g * w and t2 = -x *
rstd^3 * mean(g * w * x), where the port rounds t1 + t2 once (checked
bit for bit in `test_the_reference_rounds_each_dx_branch`). The two
branches nearly cancel in a short row, so there dx is held to one ulp of
each branch and of the result.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as TF

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
ATOL = 1e-5
DW_ATOL = 1e-4


def _inputs(rows, cols, seed):
    rng = np.random.RandomState(seed)
    return ((rng.randn(rows, cols) * 3).astype(np.float32),
            rng.randn(cols).astype(np.float32),
            rng.randn(rows, cols).astype(np.float32))


def _j(a, dtype):
    return None if a is None else jnp.asarray(a).astype(dtype)


def _t(a, dtype):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _ulp(a, dtype):
    """One unit in the last place of |a| in `dtype` (bf16 / f16)."""
    mant = 7 if dtype == "bfloat16" else 10
    tiny = float(jnp.finfo(DTYPES[dtype][1]).tiny)
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), tiny))) - mant)


def _assert_close(got, want, dtype, atol=ATOL, branches=()):
    """got: a torch tensor; want: a jax array of the same dtype; bf16 /
    f16 within one ulp of want, and one of each of `branches` (f32 arrays
    the reference rounds to `dtype` before adding them)."""
    assert got.dtype == DTYPES[dtype][0]
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
        return
    tol = _ulp(w, dtype) + sum(_ulp(b, dtype) for b in branches)
    assert np.all(np.abs(g - w) <= tol), (np.abs(g - w) / tol).max()


def _dx_branches(x, w, g, dtype):
    """t1 = rstd * g * w and t2 = -x * rstd^3 * mean(g * w * x) in f32,
    from the inputs as rounded to `dtype` (w None: 1)."""
    xf, gf = (np.asarray(_j(a, DTYPES[dtype][1]).astype(jnp.float32))
              for a in (x, g))
    wf = 1.0 if w is None else np.asarray(w.astype(jnp.float32))
    rstd = 1.0 / np.sqrt((xf * xf).mean(-1, keepdims=True) + 1e-6)
    return (rstd * gf * wf,
            -xf * rstd ** 3 * (gf * wf * xf).mean(-1, keepdims=True))


def _weights(kind, w, dtype):
    """The weight as each side takes it: None, x's dtype or float32."""
    if kind is None:
        return None, None
    td, jd = DTYPES[dtype] if kind == "same" else DTYPES["float32"]
    return _t(w, td), _j(w, jd)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("form", ["x", "x_none", "name", "keywords"])
def test_rms_norm_without_a_weight_matches_the_reference(dtype, form):
    """F.rms_norm(x), F.rms_norm(x, None), name=None: no scale, as the
    reference's XLA expression without a weight."""
    x, _, _ = _inputs(33, 256, seed=7)
    td, jd = DTYPES[dtype]
    calls = {"x": lambda f, a: f(a),
             "x_none": lambda f, a: f(a, None),
             "name": lambda f, a: f(a, None, 1e-5, name=None),
             "keywords": lambda f, a: f(a, weight=None, epsilon=1e-5,
                                        name=None)}
    want = calls[form](JF.rms_norm, _j(x, jd))
    got = calls[form](TF.rms_norm, _t(x, td))
    _assert_close(got, want._data, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("weight", ["same", "f32", None])
@pytest.mark.parametrize("rows,cols", [(17, 6), (9, 130), (3, 20000),
                                       (2500, 128), (512, 128)])
def test_rms_norm_matches_the_reference_at_any_shape(dtype, weight, rows,
                                                     cols):
    """6, 130 and 20000 columns and 2500 rows (the reference's XLA path),
    512 x 128 (its Pallas kernel with a weight), with a weight in x's
    dtype, a float32 weight, or none."""
    x, w, _ = _inputs(rows, cols, seed=rows + cols)
    td, jd = DTYPES[dtype]
    tw, jw = _weights(weight, w, dtype)
    want = JF.rms_norm(_j(x, jd), jw, 1e-6)
    got = TF.rms_norm(_t(x, td), tw, 1e-6)
    _assert_close(got, want._data, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("weight", ["same", "f32", None])
@pytest.mark.parametrize("rows,cols", [(17, 6), (9, 130), (2500, 128),
                                       (512, 128)])
def test_rms_norm_gradients_match_the_reference_vjp(dtype, weight, rows,
                                                    cols):
    """dx and dw of the port's autograd (`RMSNormFunction`: the plain
    forward and backward on the CPU) against `jax.vjp` of the reference's
    F.rms_norm on the same cotangent; dw in the weight's dtype."""
    x, w, g = _inputs(rows, cols, seed=3 * rows + cols)
    td, jd = DTYPES[dtype]
    tw, jw = _weights(weight, w, dtype)
    if jw is None:
        out, vjp = jax.vjp(lambda a: JF.rms_norm(a, None, 1e-6)._data,
                           _j(x, jd))
        (j_dx,) = vjp(_j(g, jd))
    else:
        out, vjp = jax.vjp(lambda a, b: JF.rms_norm(a, b, 1e-6)._data,
                           _j(x, jd), jw)
        j_dx, j_dw = vjp(_j(g, jd))
    xt = _t(x, td).requires_grad_()
    if tw is not None:
        tw.requires_grad_()
    y = TF.rms_norm(xt, tw, 1e-6)
    _assert_close(y.detach(), out, dtype)
    y.backward(_t(g, td))
    _assert_close(xt.grad, j_dx, dtype,
                  branches=() if dtype == "float32"
                  else _dx_branches(x, jw, g, dtype))
    if tw is not None:
        wdtype = dtype if weight == "same" else "float32"
        _assert_close(tw.grad, j_dw, wdtype, atol=DW_ATOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_the_reference_rounds_each_dx_branch(dtype):
    """The reference's dx on its XLA path is round(round(t1) + round(t2))
    bit for bit (`_dx_branches`): the premise of the gradient tolerance."""
    x, w, g = _inputs(17, 6, seed=57)
    jd = DTYPES[dtype][1]
    _, vjp = jax.vjp(lambda a, b: JF.rms_norm(a, b, 1e-6)._data,
                     _j(x, jd), _j(w, jd))
    j_dx = np.asarray(vjp(_j(g, jd))[0].astype(jnp.float32))

    def rnd(a):
        return np.asarray(jnp.asarray(a.astype(np.float32)).astype(jd)
                          .astype(jnp.float32))

    t1, t2 = _dx_branches(x, _j(w, jd), g, dtype)
    np.testing.assert_array_equal(j_dx, rnd(rnd(t1) + rnd(t2)))
    assert np.abs(j_dx - rnd(t1 + t2)).max() > 0  # rounding once differs
