"""The core's linear algebra (`paddle_tpu_torch/ops/linalg.py` and the
`paddle_tpu_torch.linalg` namespace) against the reference's: every public
function, forward and (where differentiable) the inputs' gradients of
sum(out), atol and rtol 1e-5 (1e-4 where a decomposition's f32 rounding
differs by LAPACK's path)."""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as T
from torch_core_cases import Case, args, cpu_place, f32, i64, params, run  # noqa: F401

LOOSE = (1e-4, 1e-4)


def spd(n):
    def make(rng):
        a = rng.randn(n, n)
        return (a @ a.T + n * np.eye(n)).astype(np.float32)
    return make


def well(n, batch=()):
    return lambda rng: (rng.randn(*batch, n, n) + 3 * np.eye(n)).astype(
        np.float32)


def ns(pkg):
    return pkg.linalg


CASES = [
    Case("matmul", args(f32(3, 4), f32(4, 5))),
    Case("matmul", args(f32(2, 4, 3), f32(2, 5, 4)),
         kw=dict(transpose_x=True, transpose_y=True), id="matmul_transposes"),
    Case("matmul", args(f32(2, 3, 4), f32(4)), id="matmul_vector"),
    Case("bmm", args(f32(2, 3, 4), f32(2, 4, 5))),
    Case("mm", args(f32(3, 4), f32(4, 2))),
    Case("dot", args(f32(4), f32(4))),
    Case("dot", args(f32(3, 4), f32(3, 4)), id="dot_batched"),
    Case("mv", args(f32(3, 4), f32(4))),
    Case("vecdot", args(f32(3, 4), f32(3, 4))),
    Case("matrix_transpose", args(f32(2, 3, 4))),
    Case("norm", args(f32(3, 4)), id="norm_frobenius"),
    Case("norm", args(f32(3, 4)), kw=dict(axis=1), id="norm_axis_2"),
    Case("norm", args(f32(2, 3, 4)), kw=dict(p="fro", axis=[1, 2]),
         id="norm_fro_axes"),
    Case("norm", args(f32(3, 4)), kw=dict(p=1, axis=0, keepdim=True),
         id="norm_p1"),
    Case("norm", args(f32(3, 4)), kw=dict(p=3.0), id="norm_p3"),
    Case("norm", args(f32(3, 4)), kw=dict(p=float("inf"), axis=1),
         id="norm_inf"),
    Case("norm", args(f32(3, 4)), kw=dict(p=float("-inf")), id="norm_ninf"),
    Case("norm", args(f32(3, 4)), kw=dict(p=0), grad=False, id="norm_p0"),
    Case("norm", args(f32(4, 3)), kw=dict(p="nuc", axis=[0, 1]),
         tol=LOOSE, id="norm_nuclear"),
    Case("vector_norm", args(f32(3, 4)), kw=dict(p=2.0, axis=1),
         fn=lambda pkg, *a, **k: ns(pkg).vector_norm(*a, **k)),
    Case("matrix_norm", args(f32(2, 3, 4)),
         fn=lambda pkg, *a, **k: ns(pkg).matrix_norm(*a, **k)),
    Case("dist", args(f32(3, 4), f32(3, 4))),
    Case("dist", args(f32(3, 4), f32(3, 4)), kw=dict(p=float("inf")),
         id="dist_inf"),
    Case("cdist", args(f32(3, 4), f32(5, 4))),
    Case("cross", args(f32(2, 3), f32(2, 3))),
    Case("cross", args(f32(3, 5), f32(3, 5)), kw=dict(axis=0),
         id="cross_axis0"),
    Case("tensordot", args(f32(2, 3, 4), f32(3, 4, 5))),
    Case("tensordot", args(f32(2, 3, 4), f32(4, 3, 5)),
         kw=dict(axes=[[1, 2], [1, 0]]), id="tensordot_axes"),
    Case("einsum", args("ij,jk->ik", f32(3, 4), f32(4, 5))),
    Case("einsum", args("bij->bji", f32(2, 3, 4)), id="einsum_unary"),
    Case("multi_dot", args(lambda rng: [rng.randn(3, 4).astype(np.float32),
                                        rng.randn(4, 5).astype(np.float32),
                                        rng.randn(5, 2).astype(np.float32)]),
         tol=LOOSE),
    Case("histogram", args(f32(20)), kw=dict(bins=5), grad=False),
    Case("histogram", args(f32(20)), kw=dict(bins=4, min=-1, max=1,
                                             density=True),
         grad=False, id="histogram_density"),
    Case("histogramdd", args(f32(20, 2)), kw=dict(bins=3), grad=False,
         dtype=False),
    Case("histogram_bin_edges", args(f32(20)), kw=dict(bins=6), grad=False),
    Case("bincount", args(i64(12, lo=0, hi=5)), grad=False),
    Case("bincount", args(i64(12, lo=0, hi=5), f32(12)),
         fn=lambda pkg, x, w: pkg.bincount(x, weights=w, minlength=7),
         grad=False, id="bincount_weights"),
    Case("cholesky", args(spd(4)), fn=lambda pkg, *a, **k:
         ns(pkg).cholesky(*a, **k), tol=LOOSE),
    Case("cholesky", args(spd(4)), kw=dict(upper=True), tol=LOOSE,
         fn=lambda pkg, *a, **k: ns(pkg).cholesky(*a, **k),
         id="cholesky_upper"),
    Case("cholesky_solve", args(f32(4, 2), lambda rng: np.linalg.cholesky(
        spd(4)(rng)).astype(np.float32)), tol=LOOSE,
         fn=lambda pkg, *a, **k: ns(pkg).cholesky_solve(*a, **k)),
    Case("inv", args(well(3)), tol=LOOSE,
         fn=lambda pkg, *a: ns(pkg).inv(*a)),
    Case("det", args(well(3, (2,))), tol=LOOSE,
         fn=lambda pkg, *a: ns(pkg).det(*a)),
    Case("slogdet", args(well(3)), tol=LOOSE,
         fn=lambda pkg, *a: ns(pkg).slogdet(*a)),
    Case("matrix_power", args(well(3), 3), tol=(1e-3, 1e-4),
         fn=lambda pkg, *a: ns(pkg).matrix_power(*a)),
    Case("matrix_rank", args(lambda rng: np.diag([1.0, 2.0, 0.0]).astype(
        np.float32)), grad=False, fn=lambda pkg, *a: ns(pkg).matrix_rank(*a)),
    Case("svd", args(f32(4, 3)), grad=False, tol=LOOSE,
         fn=lambda pkg, x: [abs(np.asarray(v)) for v in ns(pkg).svd(x)]
         if pkg is P else [v.abs() for v in ns(pkg).svd(x)]),
    Case("svdvals", args(f32(4, 3)), tol=LOOSE,
         fn=lambda pkg, *a: ns(pkg).svdvals(*a)),
    Case("pinv", args(f32(4, 3)), tol=LOOSE,
         fn=lambda pkg, *a: ns(pkg).pinv(*a)),
    Case("qr", args(f32(4, 3)), grad=False, tol=LOOSE,
         fn=lambda pkg, x: [abs(np.asarray(v)) for v in ns(pkg).qr(x)]
         if pkg is P else [v.abs() for v in ns(pkg).qr(x)]),
    Case("lu", args(well(4)), grad=False, tol=LOOSE),
    Case("lu_unpack", args(well(4)), grad=False, tol=LOOSE,
         fn=lambda pkg, x: pkg.lu_unpack(*pkg.lu(x)[:2])),
    Case("matrix_exp", args(f32(3, 3, lo=-0.5, hi=0.5)), tol=LOOSE,
         fn=lambda pkg, *a: ns(pkg).matrix_exp(*a)),
    Case("eig", args(spd(3)), grad=False, tol=LOOSE, dtype=False,
         fn=lambda pkg, x: np.sort(np.real(np.asarray(
             ns(pkg).eig(x)[0] if pkg is P else ns(pkg).eig(x)[0].numpy())))),
    Case("eigh", args(spd(3)), grad=False, tol=LOOSE,
         fn=lambda pkg, x: ns(pkg).eigh(x)[0]),
    Case("eigvals", args(spd(3)), grad=False, tol=LOOSE, dtype=False,
         fn=lambda pkg, x: np.sort(np.real(np.asarray(
             ns(pkg).eigvals(x) if pkg is P else ns(pkg).eigvals(x).numpy())))),
    Case("eigvalsh", args(spd(3)), tol=LOOSE,
         fn=lambda pkg, *a: ns(pkg).eigvalsh(*a)),
    Case("solve", args(well(3), f32(3, 2)), tol=LOOSE,
         fn=lambda pkg, *a: ns(pkg).solve(*a)),
    Case("triangular_solve", args(lambda rng: np.triu(well(3)(rng)),
                                  f32(3, 2)), tol=LOOSE,
         fn=lambda pkg, *a, **k: ns(pkg).triangular_solve(*a, **k)),
    Case("triangular_solve", args(lambda rng: np.tril(well(3)(rng)),
                                  f32(3, 2)),
         kw=dict(upper=False, transpose=True), tol=LOOSE,
         fn=lambda pkg, *a, **k: ns(pkg).triangular_solve(*a, **k),
         id="triangular_solve_lower_transposed"),
    Case("lstsq", args(f32(5, 3), f32(5, 2)), grad=False, tol=LOOSE,
         dtype=False, fn=lambda pkg, x, y: ns(pkg).lstsq(x, y)[0]),
    Case("corrcoef", args(f32(3, 6)), grad=False, tol=LOOSE),
    Case("cov", args(f32(3, 6)), grad=False, tol=LOOSE),
    Case("cov", args(f32(6, 3)), kw=dict(rowvar=False, ddof=False),
         grad=False, tol=LOOSE, id="cov_columns"),
    Case("pca_lowrank", args(f32(6, 4)), grad=False, tol=LOOSE,
         fn=lambda pkg, x: ns(pkg).pca_lowrank(x, q=2)[1]),
    Case("householder_product", args(f32(4, 3), f32(3, lo=0.1, hi=1.0)),
         grad=False, tol=LOOSE,
         fn=lambda pkg, *a: ns(pkg).householder_product(*a)),
    Case("ormqr", args(f32(4, 3), f32(3, lo=0.1, hi=1.0), f32(4, 2)),
         grad=False, tol=LOOSE, fn=lambda pkg, *a: ns(pkg).ormqr(*a)),
    Case("pdist", args(f32(4, 3))),
    Case("cond", args(well(3)), tol=LOOSE,
         fn=lambda pkg, *a: ns(pkg).cond(*a)),
    Case("cond", args(well(3)), kw=dict(p="fro"), tol=LOOSE,
         fn=lambda pkg, *a, **k: ns(pkg).cond(*a, **k), id="cond_fro"),
    Case("cond", args(well(3)), kw=dict(p=1), tol=LOOSE, grad=False,
         fn=lambda pkg, *a, **k: ns(pkg).cond(*a, **k), id="cond_1"),
    Case("t", args(f32(3, 4)), fn=lambda pkg, x: pkg.ops.linalg.t(x)),
    Case("inverse", args(well(3)), tol=LOOSE,
         fn=lambda pkg, x: pkg.ops.linalg.inverse(x), id="linalg_inverse"),
]


@pytest.mark.parametrize("case", params(CASES))
def test_linalg_op_matches_the_reference(case, cpu_place):
    run(case)


def test_the_linalg_namespace_holds_the_reference_s_names():
    import paddle_tpu.linalg as JL
    import paddle_tpu_torch.linalg as TL

    ref = {n for n in dir(JL) if not n.startswith("_")}
    assert ref <= {n for n in dir(TL) if not n.startswith("_")}
    assert T.linalg is TL
