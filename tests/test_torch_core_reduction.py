"""The core's reductions, comparisons and searches
(`paddle_tpu_torch/ops/{reduction,logic,search}.py`) against the
reference's: every public function, forward and (where differentiable)
the inputs' gradients of sum(out), atol and rtol 1e-5."""
import numpy as np
import pytest

from torch_core_cases import Case, args, cpu_place, f32, i64, params, pos, run  # noqa: F401

S = (3, 4, 5)

REDUCTION = (
    [Case(n, args(f32(*S)), kw=kw, id=f"{n}_{tag}")
     for n in ("sum", "mean", "max", "min", "amax", "amin", "prod",
               "logsumexp", "nansum", "nanmean")
     for tag, kw in (("all", {}), ("axis", dict(axis=1)),
                     ("axes_keepdim", dict(axis=[0, 2], keepdim=True)))]
    + [Case(n, args(f32(*S)), kw=kw, id=f"{n}_{tag}")
       for n in ("var", "std")
       for tag, kw in (("all", {}), ("axis", dict(axis=1)),
                       ("biased", dict(axis=[1, 2], unbiased=False,
                                       keepdim=True)))]
    + [Case("sum", args(i64(*S)), kw=dict(axis=1), grad=False,
            id="sum_int_promotes"),
       Case("sum", args(lambda rng: rng.rand(*S) > 0.5), grad=False,
            id="sum_bool_promotes"),
       Case("sum", args(f32(*S)), kw=dict(axis=0, dtype="float64"),
            id="sum_dtype"),
       Case("prod", args(i64(3, 4, lo=1, hi=4)), kw=dict(axis=1),
            grad=False, id="prod_int"),
       Case("all", args(lambda rng: rng.rand(*S) > 0.2), kw=dict(axis=1),
            grad=False),
       Case("any", args(lambda rng: rng.rand(*S) > 0.9),
            kw=dict(axis=[0, 2], keepdim=True), grad=False),
       Case("median", args(f32(4, 6)), kw=dict(axis=1)),
       Case("median", args(f32(5, 6)), id="median_all"),
       Case("median", args(f32(4, 6)), kw=dict(axis=0, keepdim=True,
                                               mode="min"),
            id="median_min"),
       Case("nanmedian", args(lambda rng: np.where(
           rng.rand(4, 6) > 0.8, np.nan, rng.randn(4, 6)).astype(
           np.float32)), kw=dict(axis=1), grad=False),
       Case("quantile", args(f32(4, 6), 0.3), kw=dict(axis=1)),
       Case("quantile", args(f32(4, 6), [0.25, 0.75]), kw=dict(axis=0),
            id="quantile_list"),
       Case("quantile", args(f32(4, 6), 0.5),
            kw=dict(axis=1, interpolation="lower"), id="quantile_lower"),
       Case("nanquantile", args(lambda rng: np.where(
           rng.rand(4, 6) > 0.8, np.nan, rng.randn(4, 6)).astype(
           np.float32), 0.4), kw=dict(axis=1), grad=False)]
)

LOGIC = (
    [Case(n, args(i64(4, 5, lo=0, hi=3), i64(4, 5, lo=0, hi=3)),
          grad=False)
     for n in ("equal", "not_equal", "greater_than", "greater_equal",
               "less_than", "less_equal")]
    + [Case(n, args(lambda rng: rng.rand(4, 5) > 0.5,
                    lambda rng: rng.rand(4, 5) > 0.5), grad=False)
       for n in ("logical_and", "logical_or", "logical_xor")]
    + [Case("logical_not", args(lambda rng: rng.rand(4, 5) > 0.5),
            grad=False),
       Case("equal_all", args(i64(3, lo=0, hi=2), i64(3, lo=0, hi=2)),
            grad=False),
       Case("equal_all", args(i64(3), i64(4)), grad=False,
            id="equal_all_shapes"),
       Case("allclose", args(f32(3, 4), f32(3, 4)), grad=False),
       Case("isclose", args(f32(3, 4), f32(3, 4)), kw=dict(atol=1.0),
            grad=False),
       Case("where", args(lambda rng: rng.rand(3, 4) > 0.5, f32(3, 4),
                          f32(3, 4))),
       Case("where", args(lambda rng: rng.rand(3, 4) > 0.5),
            grad=False, id="where_nonzero"),
       Case("is_empty", args(f32(0, 3)), grad=False),
       Case("isreal", args(f32(3)), grad=False),
       Case("in1d", args(i64(6), i64(3)), grad=False),
       Case("isin", args(i64(6), i64(3)), grad=False),
       Case("is_complex", args(f32(3)), grad=False),
       Case("is_floating_point", args(f32(3)), grad=False),
       Case("is_integer", args(i64(3)), grad=False),
       Case("is_tensor", args(f32(3)), grad=False)]
)

SEARCH = (
    [Case(n, args(f32(4, 6)), kw=kw, grad=False, id=f"{n}_{tag}")
     for n in ("argmax", "argmin")
     for tag, kw in (("flat", {}), ("axis", dict(axis=1)),
                     ("keepdim", dict(axis=0, keepdim=True)),
                     ("flat_keepdim", dict(keepdim=True)),
                     ("int32", dict(axis=1, dtype="int32")))]
    + [Case("argsort", args(f32(4, 6)), kw=dict(axis=1), grad=False),
       Case("argsort", args(f32(4, 6)), kw=dict(axis=0, descending=True),
            grad=False, id="argsort_descending"),
       Case("sort", args(f32(4, 6)), kw=dict(axis=1)),
       Case("sort", args(f32(4, 6)), kw=dict(axis=0, descending=True),
            id="sort_descending"),
       Case("msort", args(f32(4, 6))),
       Case("topk", args(f32(4, 6), 3)),
       Case("topk", args(f32(4, 6), 2), kw=dict(axis=0, largest=False),
            id="topk_smallest"),
       Case("kthvalue", args(f32(4, 6), 2), kw=dict(axis=1)),
       Case("kthvalue", args(f32(4, 6), 3), kw=dict(axis=0, keepdim=True),
            id="kthvalue_keepdim"),
       Case("mode", args(i64(4, 7, lo=0, hi=3)), kw=dict(axis=1),
            grad=False),
       Case("nonzero", args(i64(3, 4, lo=0, hi=2)), grad=False),
       Case("nonzero", args(i64(3, 4, lo=0, hi=2)), kw=dict(as_tuple=True),
            grad=False, id="nonzero_tuple"),
       Case("searchsorted", args(np.array([1.0, 3.0, 5.0, 7.0], np.float32),
                                 np.array([0.0, 3.0, 6.0, 9.0],
                                          np.float32)), grad=False),
       Case("searchsorted", args(np.array([[1.0, 3.0, 5.0], [2.0, 4.0, 6.0]],
                                          np.float32),
                                 np.array([[3.0, 6.0], [1.0, 4.0]],
                                          np.float32)),
            kw=dict(right=True, out_int32=True), grad=False,
            id="searchsorted_batched_right"),
       Case("bucketize", args(np.array([0.5, 3.0, 8.0], np.float32),
                              np.array([1.0, 3.0, 5.0, 7.0], np.float32)),
            grad=False),
       Case("index_of_first", args(np.array([4, 2, 7, 2], np.int64), 2),
            grad=False)]
)


@pytest.mark.parametrize("case", params(REDUCTION))
def test_reduction_matches_the_reference(case, cpu_place):
    run(case)


@pytest.mark.parametrize("case", params(LOGIC))
def test_logic_op_matches_the_reference(case, cpu_place):
    run(case)


@pytest.mark.parametrize("case", params(SEARCH))
def test_search_op_matches_the_reference(case, cpu_place):
    run(case)
