"""Carry a matrix across from the JAX package.

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
