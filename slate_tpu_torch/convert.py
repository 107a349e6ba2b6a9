"""Carry matrices and factors across from the JAX package.

``matrix_from_reference`` takes the JAX package's storage-order tile
array (as a numpy array) and the plain fields of its layout and view,
and returns this package's matrix with the same storage, element for
element.  It is the counterpart of carrying weights across, and it needs
nothing of the JAX package itself:

    M = matrix_from_reference(
        np.asarray(A.data), m=A.layout.m, n=A.layout.n, mb=A.layout.mb,
        nb=A.layout.nb, p=A.layout.p, q=A.layout.q,
        kind=type(A).__name__, uplo=A.uplo.name, op=A.op.name,
        diag=A.diag.name, device="cpu")

``pivots_from_reference`` takes its pivots' forward permutation, and
``getrf_from_reference`` a whole ``getrf`` result (the LU's tile array
and the permutation), so this package's ``getrs`` and
``getrs_from_global`` can solve with a factorization the JAX package
made.  ``geqrf_from_reference`` does the same for a ``geqrf`` result (the
factor's tile array and the T stack), for ``unmqr``, ``gels_solve_from_global``
and the LQ drivers.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .enums import Diag, Op, Uplo
from .matrix.base import BaseMatrix
from .matrix.matrix import HermitianMatrix, Matrix, SymmetricMatrix, TriangularMatrix
from .parallel.grid import ProcessGrid
from .parallel.layout import TileLayout
from .types import Pivots, TriangularFactors

_KINDS = {
    "Matrix": Matrix,
    "TriangularMatrix": TriangularMatrix,
    "SymmetricMatrix": SymmetricMatrix,
    "HermitianMatrix": HermitianMatrix,
}


def _enum(cls, v):
    return v if isinstance(v, cls) else cls.from_string(str(v))


def matrix_from_reference(
    data: np.ndarray,
    *,
    m: int,
    n: int,
    mb: int,
    nb: int,
    p: int = 1,
    q: int = 1,
    kind: str = "Matrix",
    uplo: Union[str, Uplo] = "General",
    op: Union[str, Op] = "NoTrans",
    diag: Union[str, Diag] = "NonUnit",
    device: Union[str, torch.device] = "cuda:0",
) -> BaseMatrix:
    """This package's matrix with the JAX package's tile storage (a
    (P, Q, mb, nb) array in owner-major order) on ``device``.  The p x q
    grid is kept as a logical grid on that one device."""
    if kind not in _KINDS:
        raise ValueError(f"unknown matrix kind {kind!r}; one of {sorted(_KINDS)}")
    layout = TileLayout(m, n, mb, nb, p, q)
    grid = ProcessGrid(torch.device(device), p, q)
    T = torch.tensor(np.asarray(data), device=grid.device)
    cls = _KINDS[kind]
    if cls is Matrix:
        return Matrix(T, layout, grid=grid, op=_enum(Op, op))
    return cls(T, layout, grid=grid, op=_enum(Op, op), uplo=_enum(Uplo, uplo),
               diag=_enum(Diag, diag))


def pivots_from_reference(perm: np.ndarray,
                          device: Union[str, torch.device] = "cuda:0") -> Pivots:
    """This package's Pivots for the JAX package's ``Pivots.perm`` (a
    forward row permutation over the padded rows), as int32 on
    ``device``."""
    return Pivots(torch.tensor(np.asarray(perm), dtype=torch.int32, device=device))


def getrf_from_reference(lu_data: np.ndarray, perm: np.ndarray, *, m: int, n: int,
                         mb: int, nb: int, p: int = 1, q: int = 1,
                         device: Union[str, torch.device] = "cuda:0"):
    """(LU, pivots) of this package for a JAX package ``getrf`` result:
    ``lu_data`` the LU's storage-order tile array, ``perm`` its pivots'
    permutation."""
    LU = matrix_from_reference(lu_data, m=m, n=n, mb=mb, nb=nb, p=p, q=q, device=device)
    return LU, pivots_from_reference(perm, device)


def geqrf_from_reference(fac_data: np.ndarray, T: np.ndarray, *, m: int, n: int, mb: int,
                         nb: int, p: int = 1, q: int = 1,
                         device: Union[str, torch.device] = "cuda:0"):
    """(factored Matrix, TriangularFactors) of this package for a JAX
    package ``geqrf`` result: ``fac_data`` the factor's storage-order tile
    array (V below the diagonal, R on and above), ``T`` its
    TriangularFactors' (num_panels, nb, nb) stack."""
    fac = matrix_from_reference(fac_data, m=m, n=n, mb=mb, nb=nb, p=p, q=q, device=device)
    return fac, TriangularFactors(torch.tensor(np.asarray(T), device=fac.device))
