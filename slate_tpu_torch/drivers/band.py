"""Band-matrix drivers (reference: src/gbmm.cc, hbmm.cc, tbsm.cc,
tbsmPivots.cc, gbtrf.cc, gbtrs.cc, gbsv.cc, pbtrf.cc, pbtrs.cc, pbsv.cc),
the counterpart of the JAX package's ``drivers/band.py``.

Band matrices are stored on the dense tile grid with the entries outside
the band zero (matrix/matrix.py BandMatrix), so pivoting fill-in (kl
extra superdiagonals in gbtrf, LAPACK band semantics) lands in storage
that is already there.  Narrow bands (kd < n // 4) run the windowed
kernels of ops/band_kernels.py; wide bands and matrices on a p x q grid
take the dense drivers (``getrf``/``getrs``, ``potrf``/``potrs``,
``trsm``, ``gemm``, ``hemm``), as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..aux.metrics import instrumented
from ..enums import Diag, Op, Side, Uplo
from ..exceptions import slate_assert
from ..internal import fallbacks
from ..matrix.base import single_device
from ..matrix.matrix import (
    BandMatrix,
    HermitianBandMatrix,
    HermitianMatrix,
    Matrix,
    TriangularBandMatrix,
    TriangularMatrix,
)
from ..ops import band_kernels
from ..options import Options
from ..parallel.grid import ProcessGrid
from ..parallel.layout import tiles_from_global
from ..types import Pivots
from . import blas3, chol, lu



def _on_grid(M) -> bool:
    """M is laid out for a p x q grid: a logical grid on one process (a
    mesh's operands raise at the drivers' entry), routed as the JAX
    package routes its distributed operands."""
    return M.grid is not None and M.grid.size > 1

@instrumented("gbmm")
def gbmm(alpha, A: BandMatrix, B: Matrix, beta, C: Matrix, opts=None) -> Matrix:
    """C = alpha op(A) B + beta C with band A (reference: src/gbmm.cc)."""
    Ag = A._with(op=Op.NoTrans)
    masked = Ag.data * Ag.band_mask().to(A.dtype)
    Am = Matrix(masked, Ag.layout, grid=A.grid, op=A.op)
    return blas3.gemm(alpha, Am, B, beta, C, opts)


@instrumented("hbmm")
def hbmm(side: Side, alpha, A: HermitianBandMatrix, B: Matrix, beta, C: Matrix,
         opts=None) -> Matrix:
    """C = alpha A B + beta C with Hermitian band A (reference:
    src/hbmm.cc): the hemm driver on the band-masked stored triangle
    (band_mask() already encodes the stored triangle: kl/ku follow from
    uplo/kd)."""
    masked = A.data * A.band_mask().to(A.dtype)
    Ah = HermitianMatrix(masked, A.layout, grid=A.grid, uplo=A.uplo)
    return blas3.hemm(side, alpha, Ah, B, beta, C, opts)


def _hermitian_band_full(A: HermitianBandMatrix) -> torch.Tensor:
    """The full Hermitian band from A's stored triangle, the entries
    outside the band dropped."""
    G = A.to_global()
    if A.uplo == Uplo.Lower:
        Gk = torch.triu(torch.tril(G), -A.kd)
    else:
        Gk = torch.tril(torch.triu(G), A.kd)
    F = Gk + Gk.mH
    d = torch.diagonal(Gk)
    F.diagonal().sub_(d.real.to(G.dtype) if A.is_complex else d)
    return F


def _band_narrow(kd: int, n: int) -> bool:
    """Use the O(n kd^2) windowed kernels when the band is genuinely
    narrow; wide bands lose nothing to the dense schedule."""
    return kd < n // 4


def _apply_pivots(B2: torch.Tensor, pivots: Optional[Pivots], m: int) -> torch.Tensor:
    if pivots is not None and pivots.perm.shape[0] > 0:
        Bp = torch.nn.functional.pad(B2, (0, 0, 0, pivots.perm.shape[0] - B2.shape[0]))
        return pivots.apply(Bp)[:m]
    return B2


@instrumented("tbsm")
@single_device("8b2")
def tbsm(side: Side, alpha, A: TriangularBandMatrix, B: Matrix,
         pivots: Optional[Pivots] = None, opts=None) -> Matrix:
    """Triangular band solve, optionally applying pivots first
    (reference: src/tbsm.cc + tbsmPivots.cc).

    Narrow bands run the windowed O(n kd nrhs) substitution
    (ops/band_kernels.py::band_trsm_lower); effective-upper and
    right-side cases reduce to it by index reversal / transposition
    (J U J is lower band).  Wide bands and matrices on a p x q grid run
    the dense trsm."""
    slate_assert(
        pivots is None or pivots.band_lperms is None,
        "tbsm cannot apply windowed-gbtrf pivots: the interleaved band "
        "factorization must be solved by gbtrs (net perm + plain "
        "triangular solves do not reproduce it)",
    )
    kd, n = A.kd, A.n
    eff_lower = (A.uplo == Uplo.Lower) != (A.op != Op.NoTrans)
    if not _on_grid(B) and _band_narrow(kd, n) and A.m == A.n:
        B2 = _apply_pivots(B.to_global(), pivots, B.m)
        T2 = A._with(op=Op.NoTrans).to_global()
        E = T2.mH if A.op == Op.ConjTrans else (T2.T if A.op == Op.Trans else T2)
        unit = A.diag == Diag.Unit
        if side == Side.Right:
            # X op(T) = B  <=>  op(T)^T X^T = B^T
            E, B2, eff_lower = E.T, B2.T, not eff_lower
        if eff_lower:
            X = band_kernels.band_trsm_lower(E, B2, kd, unit_diag=unit)
        else:
            # J U J is lower band: solve the reversed system
            X = torch.flip(band_kernels.band_trsm_lower(
                torch.flip(E, (0, 1)), torch.flip(B2, (0,)), kd, unit_diag=unit), (0,))
        if side == Side.Right:
            X = X.T
        return B._with(data=tiles_from_global((alpha * X).to(B.dtype), B.layout))

    B2 = _apply_pivots(B.to_global(), pivots, B.m)
    T = TriangularMatrix(A.data, A.layout, grid=A.grid, uplo=A.uplo, diag=A.diag)
    Bm = B._with(data=tiles_from_global(B2.to(B.dtype), B.layout))
    Top = T if A.op == Op.NoTrans else T._with(op=A.op)
    return blas3.trsm(side, alpha, Top, Bm, opts)


@instrumented("gbtrf")
@single_device("8b2")
def gbtrf(A: BandMatrix, opts: Optional[Options] = None
          ) -> Tuple[BandMatrix, Pivots, torch.Tensor]:
    """Band LU with partial pivoting (reference: src/gbtrf.cc).  Dense-
    stored band: pivot fill-in (up to kl extra superdiagonals) lands in
    the zero tiles above the band.

    Narrow bands run the windowed O(n (kl+w)(kl+ku+w)) kernel
    (ops/band_kernels.py::band_getrf — the gbtrf.cc in-band panel loop,
    the Hopper panel_lu kernel a window on a CUDA device) and return
    pivots carrying ``band_lperms``/``band_w``; wide bands and matrices
    on a p x q grid run the dense getrf."""
    if (not _on_grid(A) and A.m == A.n and _band_narrow(A.kl + A.ku, A.n)
            and A.op == Op.NoTrans):
        lu2d, lperms, perm, w = band_kernels.band_getrf(A.to_global(), A.kl, A.ku)
        LUb = BandMatrix(tiles_from_global(lu2d.to(A.dtype), A.layout), A.layout,
                         grid=A.grid, kl=A.kl, ku=min(A.ku + A.kl, A.n - 1))
        ok = torch.isfinite(lu2d).all() & (torch.diagonal(lu2d).abs() > 0).all()
        info = torch.where(ok, 0, 1).to(torch.int32)
        return LUb, Pivots(perm, band_lperms=lperms, band_w=w), info

    LU, piv, info = lu.getrf(Matrix(A.data, A.layout, grid=A.grid), opts)
    out = BandMatrix(LU.data, LU.layout, grid=A.grid, kl=A.kl,
                     ku=min(A.ku + A.kl, A.n - 1))
    return out, piv, info


@instrumented("gbtrs")
@single_device("8b2")
def gbtrs(LU: BandMatrix, pivots: Pivots, B: Matrix, opts=None) -> Matrix:
    """(reference: src/gbtrs.cc).

    A windowed-gbtrf factorization (pivots carry band_lperms) MUST be
    solved by the interleaved-pivot band solve (band_getrs) — the net
    perm alone does not reproduce it, so this route is taken whatever
    B's grid; fully-swapped dense factorizations go through getrs."""
    if pivots is not None and pivots.band_lperms is not None:
        if _on_grid(B):
            fallbacks.record("gbtrs", opts, "windowed band solve gathers distributed B")
        kl = LU.kl
        ku_orig = LU.ku - kl  # gbtrf stored ku = original ku + kl
        G = LU._with(op=Op.NoTrans).to_global()
        X = band_kernels.band_getrs(G, pivots.band_lperms, pivots.band_w, kl, ku_orig,
                                    B.to_global())
        return B._with(data=tiles_from_global(X.to(B.dtype), B.layout))
    return lu.getrs(Matrix(LU.data, LU.layout, grid=LU.grid), pivots, B, opts)


@instrumented("gbsv")
@single_device("8b2")
def gbsv(A: BandMatrix, B: Matrix, opts: Optional[Options] = None
         ) -> Tuple[Matrix, BandMatrix, Pivots, torch.Tensor]:
    """Band solve (reference: src/gbsv.cc = gbtrf + gbtrs)."""
    LU, piv, info = gbtrf(A, opts)
    return gbtrs(LU, piv, B, opts), LU, piv, info


@instrumented("pbtrf")
@single_device("8b2")
def pbtrf(A: HermitianBandMatrix, opts: Optional[Options] = None
          ) -> Tuple[TriangularBandMatrix, torch.Tensor]:
    """Band Cholesky (reference: src/pbtrf.cc); no fill-in beyond kd.

    Narrow bands run the windowed O(n kd^2) kernel
    (ops/band_kernels.py::band_potrf_lower — the pbtrf.cc loop
    restricted to the band); wide bands and matrices on a p x q grid run
    the dense potrf (on a CUDA device at n >= 2048 the Hopper Cholesky
    kernels)."""
    Af = _hermitian_band_full(A)
    if not _on_grid(A) and _band_narrow(A.kd, A.n):
        L2 = band_kernels.band_potrf_lower(Af, A.kd)
        info = torch.where(torch.isfinite(L2).all(), 0, 1).to(torch.int32)
        F2 = L2.mH if A.uplo == Uplo.Upper else L2
        Lb = TriangularBandMatrix(tiles_from_global(F2.to(A.dtype), A.layout), A.layout,
                                  grid=A.grid, kd=A.kd, uplo=A.uplo)
        return Lb, info

    # a band matrix built from tiles may carry no grid: keep its device
    grid = A.grid if A.grid is not None else ProcessGrid(A.device, A.layout.p, A.layout.q)
    Ah = HermitianMatrix.from_global(Af, A.layout.mb, A.layout.nb, grid=grid, uplo=A.uplo)
    L, info = chol.potrf(Ah, opts)
    return TriangularBandMatrix(L.data, L.layout, grid=A.grid, kd=A.kd, uplo=L.uplo), info


@instrumented("pbtrs")
@single_device("8b2")
def pbtrs(L: TriangularBandMatrix, B: Matrix, opts=None) -> Matrix:
    """(reference: src/pbtrs.cc): two windowed band solves on narrow
    bands, dense trsm sweeps otherwise."""
    if not _on_grid(B) and _band_narrow(L.kd, L.n):
        G = L._with(op=Op.NoTrans).to_global()
        if L.uplo == Uplo.Upper:
            G = G.mH  # A = U^H U: L_eff = U^H (lower band)
        Y = band_kernels.band_trsm_lower(G, B.to_global(), L.kd)
        # L^H solve by index reversal: J L^H J is lower band
        M = torch.flip(G, (0, 1)).mH
        X = torch.flip(band_kernels.band_trsm_lower(M, torch.flip(Y, (0,)), L.kd), (0,))
        return B._with(data=tiles_from_global(X.to(B.dtype), B.layout))
    Lt = TriangularMatrix(L.data, L.layout, grid=L.grid, uplo=L.uplo)
    return chol.potrs(Lt, B, opts)


@instrumented("pbsv")
@single_device("8b2")
def pbsv(A: HermitianBandMatrix, B: Matrix, opts: Optional[Options] = None
         ) -> Tuple[Matrix, TriangularBandMatrix, torch.Tensor]:
    """Band SPD solve (reference: src/pbsv.cc = pbtrf + pbtrs)."""
    L, info = pbtrf(A, opts)
    return pbtrs(L, B, opts), L, info
