"""Linear algebra (counterpart of `paddle_tpu/ops/linalg.py`, and of the
`paddle.linalg` namespace's functions): matmul, bmm, dot, mv, norm, the
decompositions (svd, qr, eigh, lu, cholesky), solves, inverses, einsum.

`matmul` takes `transpose_x` / `transpose_y`; `norm` with `p=None` is the
Frobenius norm over all elements (no axis), else the 2-norm of a vector
axis or the Frobenius norm of two; `svd` returns V, not V^H.
"""
from __future__ import annotations

import numpy as np
import torch

from ..tensor import Tensor, apply_op, as_array  # noqa: F401


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def f(a, b):
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return apply_op(f, x, y, _name="matmul")


def bmm(x, y, name=None):
    return apply_op(torch.matmul, x, y, _name="bmm")


def mm(input, mat2, name=None):
    return apply_op(torch.matmul, input, mat2, _name="mm")


def dot(x, y, name=None):
    return apply_op(lambda a, b: torch.sum(a * b, -1), x, y, _name="dot")


def mv(x, vec, name=None):
    return apply_op(torch.matmul, x, vec, _name="mv")


def vecdot(x, y, axis=-1, name=None):
    """The dot of vectors along `axis` (x conjugated if complex)."""
    return apply_op(lambda a, b: torch.sum(torch.conj(a) * b, int(axis)),
                    x, y, _name="vecdot")


def matrix_transpose(x, name=None):
    return apply_op(lambda a: a.transpose(-1, -2), x,
                    _name="matrix_transpose")


def _axes(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    ax = _axes(axis)

    def f(a):
        dims = tuple(range(a.dim())) if ax is None else ax
        if p is None or p == "fro":
            if ax is None:
                return torch.sqrt(torch.sum(torch.square(a)))
            if isinstance(ax, tuple) and len(ax) == 2:
                return torch.linalg.matrix_norm(a, "fro", ax, keepdim)
            return torch.linalg.vector_norm(a, 2, ax, keepdim)
        if p == "nuc":
            return torch.linalg.matrix_norm(a, "nuc", ax, keepdim)
        if p == float("inf"):
            return torch.amax(torch.abs(a), dims, keepdim)
        if p == float("-inf"):
            return torch.amin(torch.abs(a), dims, keepdim)
        if p == 0:
            return torch.sum((a != 0).to(a.dtype), dims, keepdim)
        pv = float(p)
        return torch.pow(torch.sum(torch.pow(torch.abs(a), pv), dims,
                                   keepdim), 1.0 / pv)

    return apply_op(f, x, _name="norm")


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return apply_op(lambda a: torch.linalg.matrix_norm(
        a, p, tuple(axis), keepdim), x, _name="matrix_norm")


def dist(x, y, p=2, name=None):
    def f(a, b):
        d = torch.abs(a - b)
        if p == float("inf"):
            return torch.amax(d)
        if p == float("-inf"):
            return torch.amin(d)
        if p == 0:
            return torch.sum((d != 0).to(a.dtype))
        return torch.pow(torch.sum(torch.pow(d, p)), 1.0 / p)

    return apply_op(f, x, y, _name="dist")


def cdist(x, y, p=2.0, name=None, compute_mode=None):
    def f(a, b):
        d = torch.abs(a[..., :, None, :] - b[..., None, :, :])
        if p == float("inf"):
            return torch.amax(d, -1)
        return torch.pow(torch.sum(torch.pow(d, p), -1), 1.0 / p)

    return apply_op(f, x, y, _name="cdist")


def cross(x, y, axis=9, name=None):
    def f(a, b):
        ax = axis
        if ax == 9:  # Paddle's default: the first axis of size 3
            ax = next(i for i, s in enumerate(a.shape) if s == 3)
        return torch.linalg.cross(a, b, dim=int(ax))

    return apply_op(f, x, y, _name="cross")


def t(x, name=None):
    from . import manipulation

    return manipulation.t(x)


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, torch.Tensor):
        axes = axes.tolist()
    return apply_op(lambda a, b: torch.tensordot(a, b, axes), x, y,
                    _name="tensordot")


def einsum(equation, *operands):
    ops_ = list(operands)
    if len(ops_) == 1 and isinstance(ops_[0], (list, tuple)):
        ops_ = list(ops_[0])
    return apply_op(lambda *arrs: torch.einsum(equation, *arrs), *ops_,
                    _name="einsum")


def multi_dot(x, name=None):
    return apply_op(lambda *arrs: torch.linalg.multi_dot(arrs), *list(x),
                    _name="multi_dot")


def _host(x):
    t = as_array(x)
    return t, t.detach().cpu().numpy()


def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    t, a = _host(input)
    a = a.reshape(-1)
    lo, hi = float(min), float(max)
    if lo == 0 and hi == 0:
        lo, hi = float(a.min()), float(a.max())
    w = None if weight is None else _host(weight)[1].reshape(-1)
    h, _ = np.histogram(a, bins=int(bins), range=(lo, hi), weights=w,
                        density=density)
    if not (density or w is not None):
        h = h.astype(np.int64)
    return torch.from_numpy(h).to(t.device)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    t, a = _host(x)
    w = None if weights is None else _host(weights)[1]
    h, edges = np.histogramdd(a, bins=bins, range=ranges, density=density,
                              weights=w)
    return (torch.from_numpy(h).to(t.device),
            [torch.from_numpy(e).to(t.device) for e in edges])


def bincount(x, weights=None, minlength=0, name=None):
    a = as_array(x)
    w = None if weights is None else as_array(weights, a.device)
    return torch.bincount(a, w, int(minlength))


def cholesky(x, upper=False, name=None):
    return apply_op(lambda a: torch.linalg.cholesky(a, upper=upper), x,
                    _name="cholesky")


def cholesky_solve(x, y, upper=False, name=None):
    # only the factor's triangle is read (and so takes a gradient)
    return apply_op(lambda b, c: torch.cholesky_solve(
        b, torch.triu(c) if upper else torch.tril(c), upper), x, y,
        _name="cholesky_solve")


def inv(x, name=None):
    return apply_op(torch.linalg.inv, x, _name="inv")


inverse = inv


def det(x, name=None):
    return apply_op(torch.linalg.det, x, _name="det")


def slogdet(x, name=None):
    def f(a):
        sign, logdet = torch.linalg.slogdet(a)
        return torch.stack([sign, logdet])

    return apply_op(f, x, _name="slogdet")


def matrix_power(x, n, name=None):
    return apply_op(lambda a: torch.linalg.matrix_power(a, int(n)), x,
                    _name="matrix_power")


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return torch.linalg.matrix_rank(as_array(x), rtol=tol)


def svd(x, full_matrices=False, name=None):
    u, s, vh = apply_op(lambda a: tuple(torch.linalg.svd(
        a, full_matrices=full_matrices)), x, _name="svd")
    return u, s, matrix_transpose(vh)


def svdvals(x, name=None):
    return apply_op(torch.linalg.svdvals, x, _name="svdvals")


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply_op(lambda a: torch.linalg.pinv(a, rtol=rcond,
                                                hermitian=hermitian), x,
                    _name="pinv")


def qr(x, mode="reduced", name=None):
    return apply_op(lambda a: tuple(torch.linalg.qr(a, mode=mode)), x,
                    _name="qr")


def lu(x, pivot=True, get_infos=False, name=None):
    """(LU, pivots) packed as LAPACK's getrf, pivots 1-based int32 (and a
    0-d info of zeros with `get_infos`)."""
    a = as_array(x)
    lu_, piv = torch.linalg.lu_factor(a)
    outs = [lu_, piv.to(torch.int32)]
    if get_infos:
        outs.append(torch.zeros((), dtype=torch.int32, device=a.device))
    return tuple(outs)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(P, L, U) of `lu`'s packed output, P @ L @ U == A."""
    P, L, U = torch.lu_unpack(as_array(x), as_array(y).to(torch.int32),
                              unpack_ludata, unpack_pivots)
    return (P if unpack_pivots else None,
            L if unpack_ludata else None, U if unpack_ludata else None)


def matrix_exp(x, name=None):
    return apply_op(torch.linalg.matrix_exp, x, _name="matrix_exp")


def eig(x, name=None):
    t, a = _host(x)
    w, v = np.linalg.eig(a)
    return torch.from_numpy(w).to(t.device), torch.from_numpy(v).to(t.device)


def eigh(x, UPLO="L", name=None):
    # the reference symmetrizes its input ((A + A^H) / 2) before eigh
    return apply_op(lambda a: tuple(torch.linalg.eigh(
        (a + a.transpose(-1, -2).conj()) / 2)), x, _name="eigh")


def eigvals(x, name=None):
    t, a = _host(x)
    return torch.from_numpy(np.linalg.eigvals(a)).to(t.device)


def eigvalsh(x, UPLO="L", name=None):
    return apply_op(lambda a: torch.linalg.eigvalsh(a, UPLO), x,
                    _name="eigvalsh")


def solve(x, y, name=None):
    return apply_op(torch.linalg.solve, x, y, _name="solve")


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def f(a, b):
        if transpose:
            a, up = a.transpose(-1, -2), not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)

    return apply_op(f, x, y, _name="triangular_solve")


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values), numpy's lstsq."""
    t, a = _host(x)
    b = _host(y)[1]
    sol, res, rank, sv = np.linalg.lstsq(a, b, rcond=rcond)
    out = (sol, res, np.asarray(rank, np.int64), sv)
    return tuple(torch.from_numpy(np.asarray(o)).to(t.device) for o in out)


def corrcoef(x, rowvar=True, name=None):
    a = as_array(x)
    return torch.corrcoef(a if rowvar else a.t())


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    a = as_array(x)
    return torch.cov(a if rowvar else a.t(), correction=1 if ddof else 0,
                     fweights=None if fweights is None else
                     as_array(fweights, a.device),
                     aweights=None if aweights is None else
                     as_array(aweights, a.device))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """The reference's: the top q of an exact SVD of the (centered)
    matrix."""
    a = as_array(x)
    if q is None:
        q = min(6, a.shape[-2], a.shape[-1])
    if center:
        a = a - a.mean(-2, keepdim=True)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    return u[..., :q], s[..., :q], vh.transpose(-1, -2)[..., :q]


def householder_product(x, tau, name=None):
    return apply_op(torch.linalg.householder_product, x, tau,
                    _name="householder_product")


def ormqr(x, tau, y, left=True, transpose=False, name=None):
    """`y` multiplied by the orthogonal Q of geqrf's reflectors."""
    return apply_op(lambda a, t, b: torch.ormqr(a, t, b, left, transpose),
                    x, tau, y, _name="ormqr")


def pdist(x, p=2.0, name=None):
    """The condensed pairwise distances of an [N, D] matrix (cdist's strict
    upper triangle)."""
    n = as_array(x).shape[0]
    full = cdist(x, x, p=p)
    return apply_op(lambda d: d[tuple(torch.triu_indices(
        n, n, 1, device=d.device))], full, _name="pdist")


def histogram_bin_edges(input, bins=100, min=0.0, max=0.0, name=None):
    a = as_array(input)
    lo, hi = float(min), float(max)
    if lo == 0.0 and hi == 0.0:
        lo, hi = float(a.min()), float(a.max())
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
    return torch.linspace(lo, hi, int(bins) + 1, dtype=torch.float32,
                          device=a.device)


def cond(x, p=None, name=None):
    """The condition number ||A||_p ||A^-1||_p; p None or 2 by singular
    values."""
    def f(a):
        if p is None or p == 2:
            s = torch.linalg.svdvals(a)
            return s[..., 0] / s[..., -1]
        if p == -2:
            s = torch.linalg.svdvals(a)
            return s[..., -1] / s[..., 0]
        if p == "fro":
            ia = torch.linalg.inv(a)
            return (torch.sqrt(torch.sum(a * a, (-2, -1)))
                    * torch.sqrt(torch.sum(ia * ia, (-2, -1))))
        ia = torch.linalg.inv(a)
        if p in (1, -1):
            axis = -2
        elif p in (np.inf, -np.inf):
            axis = -1
        else:
            raise ValueError(f"cond: unsupported p {p}")
        red = torch.amax if p in (1, np.inf) else torch.amin
        return (red(torch.sum(torch.abs(a), axis), -1)
                * red(torch.sum(torch.abs(ia), axis), -1))

    return apply_op(f, x, _name="cond")
