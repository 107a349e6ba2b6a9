"""Simplified verb-named API (reference: include/slate/simplified_api.hh:
15-848 — multiply, rank_k_update, triangular_solve, lu_solve, chol_solve,
least_squares_solve, ...), the verbs of the slices this package carries.

A thin overload layer over the drivers, dispatching on matrix kind like
the reference's C++ overload set.  Functional: outputs are returned.
The band verbs dispatch on the band kinds (gbmm/hbmm, tbsm, gbsv/gbtrs,
pbtrf/pbsv/pbtrs), the indefinite verbs call hetrf/hesv/hetrs, the
eigenvalue verbs heev and the SVD verbs svd.  ``ProcessGrid`` (its
``from_ranks`` builds a mesh) is re-exported for the grids the verbs'
matrices live on; the multiply and rank-k verbs take meshes.
"""

from __future__ import annotations

from .drivers import band as _band
from .drivers import blas3 as _blas3
from .drivers import chol as _chol
from .drivers import eig as _eig
from .drivers import indefinite as _indef
from .drivers import lu as _lu
from .drivers import mixed as _mixed
from .drivers import qr as _qr
from .drivers import svd as _svd
from .enums import Side
from .exceptions import NumericalError
from .matrix.matrix import (
    BandMatrix,
    HermitianBandMatrix,
    HermitianMatrix,
    Matrix,
    SymmetricMatrix,
    TriangularBandMatrix,
    TriangularMatrix,
)
from .parallel.grid import ProcessGrid  # noqa: F401 (re-export: the mesh constructor)


# ----- level 3 -------------------------------------------------------------


def multiply(alpha, A, B, beta, C, opts=None):
    """C = alpha A B + beta C, dispatched on A/B kind (simplified_api.hh
    multiply overloads for gemm/hemm/symm/gbmm/hbmm)."""
    if isinstance(A, BandMatrix):
        return _band.gbmm(alpha, A, B, beta, C, opts)
    if isinstance(A, HermitianMatrix):
        return _blas3.hemm(Side.Left, alpha, A, B, beta, C, opts)
    if isinstance(B, HermitianMatrix):
        return _blas3.hemm(Side.Right, alpha, B, A, beta, C, opts)
    if isinstance(A, SymmetricMatrix):
        return _blas3.symm(Side.Left, alpha, A, B, beta, C, opts)
    if isinstance(B, SymmetricMatrix):
        return _blas3.symm(Side.Right, alpha, B, A, beta, C, opts)
    return _blas3.gemm(alpha, A, B, beta, C, opts)


def rank_k_update(alpha, A, beta, C, opts=None):
    """C = alpha A A^H/T + beta C (herk/syrk overloads)."""
    if isinstance(C, HermitianMatrix):
        return _blas3.herk(alpha, A, beta, C, opts)
    return _blas3.syrk(alpha, A, beta, C, opts)


def rank_2k_update(alpha, A, B, beta, C, opts=None):
    """C = alpha A B^H + conj(alpha) B A^H + beta C (her2k/syr2k overloads)."""
    if isinstance(C, HermitianMatrix):
        return _blas3.her2k(alpha, A, B, beta, C, opts)
    return _blas3.syr2k(alpha, A, B, beta, C, opts)


def triangular_multiply(alpha, A: TriangularMatrix, B, side=Side.Left, opts=None):
    return _blas3.trmm(side, alpha, A, B, opts)


def triangular_solve(alpha, A, B, side=Side.Left, pivots=None, opts=None):
    """trsm / tbsm overloads."""
    if isinstance(A, TriangularBandMatrix):
        return _band.tbsm(side, alpha, A, B, pivots, opts)
    return _blas3.trsm(side, alpha, A, B, opts)


def band_multiply(alpha, A: BandMatrix, B, beta, C, opts=None):
    return _band.gbmm(alpha, A, B, beta, C, opts)


# ----- LU ------------------------------------------------------------------


def lu_factor(A: Matrix, opts=None):
    return _lu.getrf(A, opts)


def lu_factor_nopiv(A: Matrix, opts=None):
    return _lu.getrf_nopiv(A, opts)


def lu_solve(A, B, opts=None):
    """Solve A X = B (gesv / gbsv overloads)."""
    if isinstance(A, BandMatrix):
        X, *_ = _band.gbsv(A, B, opts)
        return X
    X, *_ = _lu.gesv(A, B, opts)
    return X


def lu_solve_using_factor(LU, pivots, B, opts=None):
    if isinstance(LU, BandMatrix):
        return _band.gbtrs(LU, pivots, B, opts)
    return _lu.getrs(LU, pivots, B, opts)


def lu_solve_using_factor_nopiv(LU, B, opts=None):
    return _lu.getrs_nopiv(LU, B, opts)


def lu_inverse_using_factor(LU, pivots, opts=None):
    return _lu.getri(LU, pivots, opts)


def lu_inverse_using_factor_out_of_place(LU, pivots, opts=None):
    """(reference: getriOOP — out-of-place is the only mode in the
    functional API)"""
    return _lu.getri(LU, pivots, opts)


# ----- Cholesky ------------------------------------------------------------


def chol_factor(A, opts=None):
    if isinstance(A, HermitianBandMatrix):
        return _band.pbtrf(A, opts)
    return _chol.potrf(A, opts)


def chol_solve(A, B, opts=None):
    if isinstance(A, HermitianBandMatrix):
        X, *_ = _band.pbsv(A, B, opts)
        return X
    X, *_ = _chol.posv(A, B, opts)
    return X


def chol_solve_using_factor(L, B, opts=None):
    if isinstance(L, TriangularBandMatrix):
        return _band.pbtrs(L, B, opts)
    return _chol.potrs(L, B, opts)


def solve_mixed(A, B, opts=None):
    """Mixed-precision solve with iterative refinement, dispatched on
    matrix kind (HermitianMatrix -> posv_mixed, else gesv_mixed).
    Returns only X, so it demands the success contract itself: with the
    fallback solver on (the default) a non-converging system is
    re-solved at full precision; with it off, non-convergence raises
    NumericalError — never a silently-wrong finite X."""
    if isinstance(A, HermitianMatrix):
        X, info, _iters = _mixed.posv_mixed(A, B, opts)
    else:
        X, info, _iters = _mixed.gesv_mixed(A, B, opts)
    if int(info) != 0:
        raise NumericalError(
            f"solve_mixed: refinement did not converge (info={int(info)})", int(info))
    return X


def chol_inverse_using_factor(L, opts=None):
    return _chol.potri(L, opts)


# ----- indefinite ----------------------------------------------------------


def indefinite_factor(A: HermitianMatrix, opts=None):
    return _indef.hetrf(A, opts)


def indefinite_solve(A: HermitianMatrix, B, opts=None):
    """Solve with breakdown surfaced: this verb returns only X, so it
    demands the success flag itself (the lazy-info contract) and raises
    NumericalError when info != 0."""
    X, _L, _d, info = _indef.hesv(A, B, opts)
    if int(info) != 0:
        raise NumericalError(
            f"indefinite_solve: factorization breakdown (info={int(info)})", int(info))
    return X


def indefinite_solve_using_factor(L, d, B, opts=None):
    return _indef.hetrs(L, d, B, opts)


# ----- least squares / QR / LQ --------------------------------------------


def least_squares_solve(A: Matrix, B: Matrix, opts=None):
    return _qr.gels(A, B, opts)


def qr_factor(A: Matrix, opts=None):
    return _qr.geqrf(A, opts)


def lq_factor(A: Matrix, opts=None):
    return _qr.gelqf(A, opts)


def multiply_by_q(side, op, fac, T, C, from_lq=False, opts=None):
    """Apply Q from qr_factor / lq_factor (unmqr/unmlq overloads)."""
    if from_lq:
        return _qr.unmlq(side, op, fac, T, C, opts)
    return _qr.unmqr(side, op, fac, T, C, opts)


# ----- eigen / svd ---------------------------------------------------------


def eig(A: HermitianMatrix, opts=None):
    """Eigenvalues + vectors (simplified_api.hh eig)."""
    return _eig.heev(A, opts, vectors=True)


def eig_vals(A: HermitianMatrix, opts=None):
    """Eigenvalues only (simplified_api.hh eig_vals)."""
    w, _ = _eig.heev(A, opts, vectors=False)
    return w


def svd(A: Matrix, opts=None):
    """Singular values and vectors (simplified_api.hh svd): (s, U, VH)."""
    return _svd.svd(A, opts, vectors=True)


def svd_vals(A: Matrix, opts=None):
    """Singular values only (simplified_api.hh svd_vals)."""
    s, _, _ = _svd.svd(A, opts, vectors=False)
    return s
