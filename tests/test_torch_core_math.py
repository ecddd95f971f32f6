"""The core's elementwise math (`paddle_tpu_torch/ops/math.py`) against
`paddle_tpu/ops/math.py`: every public function, forward and (where it is
differentiable) the inputs' gradients of sum(out), on the same numpy
inputs, atol and rtol 1e-5."""
import numpy as np
import pytest

from torch_core_cases import Case, args, cpu_place, f32, i64, params, pos, run  # noqa: F401

S = (3, 4)

BINARY_F = ["add", "subtract", "multiply", "maximum", "minimum", "fmax",
            "fmin", "atan2", "hypot", "logaddexp", "copysign"]
UNARY_F = ["exp", "expm1", "sin", "cos", "tan", "atan", "sinh", "cosh",
           "tanh", "asinh", "erf", "square", "abs", "neg", "negative",
           "positive", "sign", "sgn", "floor", "ceil", "trunc", "frac",
           "deg2rad", "rad2deg", "sinc", "i0", "i0e", "i1", "i1e",
           "real", "conj"]
UNARY_POS = ["log", "log2", "log10", "log1p", "sqrt", "rsqrt", "reciprocal",
             "lgamma", "digamma", "gammaln", "acosh"]
UNARY_UNIT = ["asin", "acos", "atanh", "erfinv"]

CASES = (
    [Case(n, args(f32(*S), f32(*S))) for n in BINARY_F]
    + [Case(n, args(f32(*S), pos(*S)), id=n) for n in ("divide", "pow")]
    + [Case("pow", args(pos(*S), 3.0), id="pow_scalar"),
       Case("add", args(f32(2, 3, 4), f32(4)), id="add_broadcast"),
       Case("multiply", args(f32(*S), 2.5), id="multiply_scalar")]
    + [Case(n, args(f32(*S))) for n in UNARY_F]
    + [Case(n, args(pos(*S, lo=1.2, hi=3.0) if n == "acosh" else pos(*S)))
       for n in UNARY_POS]
    + [Case(n, args(f32(*S, lo=-0.9, hi=0.9))) for n in UNARY_UNIT]
    # the integer ops: floor division and the remainder take the divisor's
    # sign on negative integers
    + [Case(n, args(i64(5, 6, lo=-20, hi=21), i64(5, 6, lo=1, hi=7)),
            grad=False) for n in ("floor_divide", "mod", "remainder",
                                   "floor_mod")]
    + [Case(n, args(i64(5, 6, lo=-20, hi=21), i64(5, 6, lo=-7, hi=-1)),
            grad=False, id=n + "_negative_divisor")
       for n in ("floor_divide", "mod")]
    + [Case(n, args(f32(*S, lo=-5, hi=5), pos(*S)), id=n + "_float")
       for n in ("floor_divide", "mod")]
    + [Case(n, args(i64(*S, lo=1, hi=40), i64(*S, lo=1, hi=40)),
            grad=False) for n in ("gcd", "lcm")]
    + [Case(n, args(i64(*S, lo=-50, hi=50), i64(*S, lo=-50, hi=50)),
            grad=False) for n in ("bitwise_and", "bitwise_or",
                                   "bitwise_xor")]
    + [Case(n, args(i64(*S, lo=0, hi=50), i64(*S, lo=0, hi=4)),
            grad=False) for n in ("bitwise_left_shift",
                                   "bitwise_right_shift")]
    + [Case("bitwise_not", args(i64(*S)), grad=False),
       Case("nextafter", args(f32(*S), f32(*S)), grad=False),
       Case("heaviside", args(f32(*S), f32(*S)), grad=False),
       Case("ldexp", args(f32(*S), i64(*S, lo=-3, hi=4)), grad=False),
       Case("signbit", args(f32(*S)), grad=False),
       Case("isneginf", args(np.array([1.0, -np.inf, np.inf, 0.0],
                                      np.float32)), grad=False),
       Case("isposinf", args(np.array([1.0, -np.inf, np.inf, 0.0],
                                      np.float32)), grad=False),
       Case("isnan", args(np.array([1.0, np.nan, np.inf], np.float32)),
            grad=False),
       Case("isinf", args(np.array([1.0, np.nan, -np.inf], np.float32)),
            grad=False),
       Case("isfinite", args(np.array([1.0, np.nan, np.inf], np.float32)),
            grad=False),
       Case("exponent", args(f32(*S)), grad=False),
       Case("angle", args(f32(*S)), grad=False),
       Case("imag", args(f32(*S)), grad=False),
       Case("round", args(f32(*S, lo=-5, hi=5)), grad=False),
       Case("round", args(f32(*S, lo=-5, hi=5)), kw=dict(decimals=1),
            grad=False, id="round_decimals"),
       Case("cast", args(f32(*S), "int32"), grad=False),
       Case("cast", args(f32(*S), "float64"), id="cast_float64"),
       Case("scale", args(f32(*S)), kw=dict(scale=2.0, bias=0.5)),
       Case("scale", args(f32(*S)),
            kw=dict(scale=2.0, bias=0.5, bias_after_scale=False),
            id="scale_bias_first"),
       Case("scale", args(f32(*S)), kw=dict(scale=3.0, act="tanh"),
            id="scale_act"),
       Case("clip", args(f32(*S)), kw=dict(min=-0.5, max=0.7)),
       Case("clip", args(f32(*S)), kw=dict(max=0.3), id="clip_max"),
       Case("lerp", args(f32(*S), f32(*S), 0.3)),
       Case("lerp", args(f32(*S), f32(*S), f32(*S, lo=0, hi=1)),
            id="lerp_tensor_weight"),
       Case("stanh", args(f32(*S))),
       Case("multiplex", args([f32(*S)(np.random.RandomState(1)),
                               f32(*S)(np.random.RandomState(2))],
                              np.array([[1], [0], [1]], np.int32)),
            grad=False),
       Case("cumsum", args(f32(*S)), kw=dict(axis=1)),
       Case("cumsum", args(f32(*S)), id="cumsum_flat"),
       Case("cumsum", args(i64(*S)), kw=dict(axis=0, dtype="float32"),
            id="cumsum_dtype", grad=False),
       Case("cumprod", args(f32(*S)), kw=dict(dim=1)),
       Case("cumprod", args(f32(*S)), id="cumprod_flat"),
       Case("cummax", args(f32(3, 6)), kw=dict(axis=1)),
       Case("cummin", args(f32(3, 6)), kw=dict(axis=0)),
       Case("cummax", args(i64(8, lo=0, hi=4)), grad=False,
            id="cummax_ties"),
       Case("logcumsumexp", args(f32(*S)), kw=dict(axis=1)),
       Case("nan_to_num", args(np.array([1.0, np.nan, np.inf, -np.inf],
                                        np.float32)),
            kw=dict(nan=0.5, posinf=9.0, neginf=-9.0)),
       Case("addmm", args(f32(3, 5), f32(3, 4), f32(4, 5)),
            kw=dict(beta=0.5, alpha=2.0)),
       Case("inner", args(f32(3, 4), f32(5, 4))),
       Case("outer", args(f32(3), f32(4))),
       Case("kron", args(f32(2, 3), f32(3, 2))),
       Case("trace", args(f32(4, 4)), kw=dict(offset=1)),
       Case("diagonal", args(f32(3, 4, 5)), kw=dict(offset=-1, axis1=1,
                                                     axis2=2)),
       Case("diff", args(f32(3, 6)), kw=dict(n=2, axis=1)),
       Case("diff", args(f32(6), f32(2), f32(3)),
            fn=lambda pkg, x, p, a: pkg.diff(x, prepend=p, append=a),
            id="diff_prepend_append"),
       Case("rot90", args(f32(3, 4)), kw=dict(k=3)),
       Case("take", args(f32(*S), np.array([0, 5, -1, 11], np.int64))),
       Case("take", args(f32(*S), np.array([0, 15, -3], np.int64)),
            kw=dict(mode="wrap"), id="take_wrap"),
       Case("take", args(f32(*S), np.array([0, 15, -3], np.int64)),
            kw=dict(mode="clip"), id="take_clip"),
       Case("broadcast_shape", args([2, 1, 4], [3, 1]), grad=False),
       Case("count_nonzero", args(i64(4, 5, lo=-1, hi=2)),
            kw=dict(axis=1), grad=False),
       Case("polygamma", args(pos(*S), 1)),
       Case("multigammaln", args(pos(*S, lo=2.0, hi=4.0), 3)),
       Case("logit", args(f32(*S, lo=0.05, hi=0.95))),
       Case("logit", args(f32(*S, lo=0.0, hi=1.0)), kw=dict(eps=0.1),
            id="logit_eps"),
       Case("frexp", args(f32(*S)), grad=False),
       Case("trapezoid", args(f32(3, 5)), kw=dict(dx=0.5)),
       Case("trapezoid", args(f32(3, 5), f32(3, 5)),
            fn=lambda pkg, y, x: pkg.trapezoid(y, x=x), id="trapezoid_x"),
       Case("cumulative_trapezoid", args(f32(3, 5))),
       Case("cumulative_trapezoid", args(f32(3, 5), f32(3, 5)),
            fn=lambda pkg, y, x: pkg.cumulative_trapezoid(y, x=x),
            id="cumulative_trapezoid_x"),
       Case("renorm", args(f32(3, 4, lo=-3, hi=3), 2.0, 1, 2.0)),
       Case("add_n", args([f32(*S)(np.random.RandomState(3)),
                           f32(*S)(np.random.RandomState(4)),
                           f32(*S)(np.random.RandomState(5))]),
            grad=False),
       Case("rank", args(f32(2, 3, 4)), grad=False),
       Case("inverse", args(lambda rng: (rng.randn(3, 3) + 3 * np.eye(3))
                            .astype(np.float32)), tol=(1e-4, 1e-4)),
       Case("igamma", args(pos(*S), pos(*S)), grad=False),
       Case("igammac", args(pos(*S), pos(*S)), grad=False),
       Case("gammainc", args(pos(*S), pos(*S)), grad=False),
       Case("gammaincc", args(pos(*S), pos(*S)), grad=False),
       Case("increment", args(f32(1)), kw=dict(value=2.0), grad=False)]
)


@pytest.mark.parametrize("case", params(CASES))
def test_math_op_matches_the_reference(case, cpu_place):
    run(case)
