"""Concrete matrix classes (reference: include/slate/Matrix.hh,
TrapezoidMatrix.hh, TriangularMatrix.hh, SymmetricMatrix.hh,
HermitianMatrix.hh).

All kinds share the full (P, Q, mb, nb) tile storage; the triangular,
symmetric and Hermitian kinds reference one triangle.  ``from_global``
places the tiles on the grid's device (``default_grid()`` when no grid
is given, i.e. ``cuda:0``).  The band kinds (``BandMatrix``,
``TriangularBandMatrix``, ``HermitianBandMatrix``) keep the same dense
tile storage with the entries outside the band zero, and carry their
bandwidths (``kl``/``ku``, ``kd``) as attributes.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..enums import Diag, Op, Uplo
from ..exceptions import slate_assert
from ..internal import tile_ops
from ..parallel.grid import ProcessGrid, default_grid
from ..parallel.layout import TileLayout, index_maps, local_tiles, tiles_from_global
from .base import BaseMatrix, conj_transpose, transpose  # noqa: F401 (re-export)


def _make_layout(m, n, mb, nb, grid: ProcessGrid) -> TileLayout:
    return TileLayout(m, n, mb, nb, grid.p, grid.q)


def _place(A, grid: Optional[ProcessGrid]):
    """(tensor on the grid's device, grid) for a numpy array or tensor."""
    grid = grid if grid is not None else default_grid()
    return torch.as_tensor(A, device=grid.device), grid


class Matrix(BaseMatrix):
    """General m x n matrix (reference: Matrix.hh)."""

    @staticmethod
    def from_global(
        A, mb: int, nb: Optional[int] = None, grid: Optional[ProcessGrid] = None
    ) -> "Matrix":
        """Build from an (m, n) array (reference: Matrix::fromLAPACK); on
        a mesh every rank passes the same A and keeps its block."""
        nb = nb if nb is not None else mb
        A, grid = _place(A, grid)
        m, n = A.shape
        layout = _make_layout(m, n, mb, nb, grid)
        return Matrix(local_tiles(tiles_from_global(A, layout), layout, grid), layout, grid=grid)

    @staticmethod
    def zeros(m: int, n: int, mb: int, nb: Optional[int] = None, dtype=torch.float32,
              grid: Optional[ProcessGrid] = None) -> "Matrix":
        """An m x n zero matrix on the grid's device (this rank's block
        on a mesh)."""
        nb = nb if nb is not None else mb
        grid = grid if grid is not None else default_grid()
        layout = _make_layout(m, n, mb, nb, grid)
        shape = layout.local_shape if grid.is_distributed else layout.storage_shape
        return Matrix(torch.zeros(shape, dtype=dtype, device=grid.device), layout, grid=grid)


class BaseTrapezoidMatrix(BaseMatrix):
    """Upper/lower trapezoid storage semantics (reference:
    BaseTrapezoidMatrix.hh)."""

    def __init__(self, data, layout, grid=None, op=Op.NoTrans,
                 uplo=Uplo.Lower, diag=Diag.NonUnit):
        super().__init__(data, layout, grid=grid, op=op)
        self.uplo = uplo
        self.diag = diag

    @classmethod
    def from_global(cls, A, mb, nb=None, grid=None, uplo=Uplo.Lower,
                    diag=Diag.NonUnit):
        nb = nb if nb is not None else mb
        A, grid = _place(A, grid)
        m, n = A.shape
        layout = _make_layout(m, n, mb, nb, grid)
        return cls(local_tiles(tiles_from_global(A, layout), layout, grid), layout, grid=grid,
                   uplo=uplo, diag=diag)

    def tri_mask(self) -> torch.Tensor:
        """(P, Q, mb, nb) bool mask of the referenced triangle's elements
        (valid region only), the diagonal left out for Diag.Unit; this
        rank's block of it on a mesh."""
        return tile_ops.tri_mask(self.layout, self.uplo, self.diag, device=self.data.device,
                                 grid=self.grid)


class TrapezoidMatrix(BaseTrapezoidMatrix):
    """m x n trapezoid (reference: TrapezoidMatrix.hh)."""


class TriangularMatrix(BaseTrapezoidMatrix):
    """Square triangular (reference: TriangularMatrix.hh)."""

    @classmethod
    def from_global(cls, A, mb, nb=None, grid=None, uplo=Uplo.Lower,
                    diag=Diag.NonUnit):
        slate_assert(A.shape[0] == A.shape[1], "TriangularMatrix must be square")
        return super().from_global(A, mb, nb, grid, uplo, diag)


def _stored_triangle(M: BaseTrapezoidMatrix) -> torch.Tensor:
    """The stored triangle of M, zeros elsewhere (the other triangle is
    not read: tril/triu write zeros, so NaN there does not enter)."""
    A = M.to_global()
    return torch.tril(A) if M.uplo == Uplo.Lower else torch.triu(A)


class SymmetricMatrix(BaseTrapezoidMatrix):
    """Symmetric, one triangle referenced (reference: SymmetricMatrix.hh)."""

    def __init__(self, data, layout, grid=None, op=Op.NoTrans,
                 uplo=Uplo.Lower, diag=Diag.NonUnit):
        super().__init__(data, layout, grid=grid, op=op, uplo=uplo, diag=Diag.NonUnit)

    def full_global(self) -> torch.Tensor:
        """Materialize the full symmetric matrix from the stored triangle."""
        Ak = _stored_triangle(self)
        return Ak + Ak.T - torch.diag(torch.diagonal(Ak))


class HermitianMatrix(SymmetricMatrix):
    """Hermitian, one triangle referenced (reference: HermitianMatrix.hh)."""

    def full_global(self) -> torch.Tensor:
        Ak = _stored_triangle(self)
        d = torch.diagonal(Ak)
        diag_part = torch.diag(d.real.to(Ak.dtype) if Ak.is_complex() else d)
        return Ak + Ak.mH - diag_part


# ---------------------------------------------------------------------------
# Band kinds (reference: BandMatrix.hh, TriangularBandMatrix.hh,
# HermitianBandMatrix.hh).  Dense tile storage + bandwidth metadata; tiles
# wholly outside the band are zero.
# ---------------------------------------------------------------------------


class BandMatrix(Matrix):
    """General band matrix with lower/upper bandwidth (kl, ku)."""

    def __init__(self, data, layout, grid=None, op=Op.NoTrans, kl=0, ku=0):
        super().__init__(data, layout, grid=grid, op=op)
        self.kl = kl
        self.ku = ku

    @staticmethod
    def from_global(A, kl, ku, mb, nb=None, grid=None) -> "BandMatrix":
        """Build from an (m, n) array, the entries outside the band
        dropped."""
        nb = nb if nb is not None else mb
        A, grid = _place(A, grid)
        m, n = A.shape
        # j - i <= ku and i - j <= kl; triu/tril write zeros, as the JAX
        # package's where does
        A = torch.triu(torch.tril(A, ku), -kl)
        layout = _make_layout(m, n, mb, nb, grid)
        return BandMatrix(local_tiles(tiles_from_global(A, layout), layout, grid), layout,
                          grid=grid, kl=kl, ku=ku)

    def band_mask(self) -> torch.Tensor:
        """(P, Q, mb, nb) bool mask of the band's elements (valid region
        only)."""
        gr, gc, valid = index_maps(self.layout, self.data.device, self.grid)
        return ((gc - gr) <= self.ku) & ((gr - gc) <= self.kl) & valid


class TriangularBandMatrix(BandMatrix):
    """Triangular band (reference: TriangularBandMatrix.hh)."""

    def __init__(self, data, layout, grid=None, op=Op.NoTrans, kd=0,
                 uplo=Uplo.Lower, diag=Diag.NonUnit):
        kl, ku = (kd, 0) if uplo == Uplo.Lower else (0, kd)
        super().__init__(data, layout, grid=grid, op=op, kl=kl, ku=ku)
        self.uplo = uplo
        self.diag = diag
        self.kd = kd


class HermitianBandMatrix(TriangularBandMatrix):
    """Hermitian band, one triangle stored (reference: HermitianBandMatrix.hh)."""

    def full_global(self) -> torch.Tensor:
        """Materialize the full Hermitian band from the stored triangle
        (entries outside the referenced triangle are not read)."""
        A = self.to_global()
        if self.uplo == Uplo.Lower:
            kept, strict = torch.tril(A), torch.tril(A, -1)
        else:
            kept, strict = torch.triu(A), torch.triu(A, 1)
        return kept + strict.mH
