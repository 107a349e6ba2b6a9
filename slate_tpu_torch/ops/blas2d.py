"""2D-level BLAS on global tensors — the "global path" (reference
analogue: blaspp vendor BLAS called per tile, Tile_blas.hh:19-941).

On one device the best schedule for a tiled BLAS3 op is the one large
library call, so plain triangular solves and products go to
``torch.linalg.solve_triangular`` and ``torch.matmul`` (TF32 off), as
the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch

from ..enums import Diag, Op, Side, Uplo
from ..internal.precision import hdot


def apply_op(A: torch.Tensor, op: Op) -> torch.Tensor:
    if op == Op.Trans:
        return A.T
    if op == Op.ConjTrans:
        return A.mH
    return A


def gemm2d(alpha, A, B, beta, C):
    """C = alpha A B + beta C (reference: tile::gemm, Tile_blas.hh:30)."""
    return (alpha * hdot(A, B) + beta * C).to(C.dtype)


def syrk2d(alpha, A, beta, C):
    """C = alpha A A^T + beta C (reference: tile::syrk, Tile_blas.hh:523)."""
    return gemm2d(alpha, A, A.T, beta, C)


def herk2d(alpha, A, beta, C):
    """C = alpha A A^H + beta C (reference: tile::herk)."""
    return gemm2d(alpha, A, A.mH, beta, C)


def _tri_take(A, uplo: Uplo, diag: Diag):
    """Materialize the referenced triangle of A (unit diag -> ones)."""
    T = torch.tril(A) if uplo == Uplo.Lower else torch.triu(A)
    if diag == Diag.Unit:
        T = T - torch.diag(torch.diagonal(T)) + torch.eye(
            A.shape[0], dtype=A.dtype, device=A.device
        )
    return T


def trsm2d(side: Side, uplo: Uplo, op: Op, diag: Diag, alpha, A, B):
    """Solve op(T(A)) X = alpha B (or X op(T(A)) = alpha B)
    (reference: tile::trsm, Tile_blas.hh:682).  Only the ``uplo``
    triangle of A is read."""
    Aop = apply_op(A, op)
    upper = (uplo == Uplo.Upper) == (op == Op.NoTrans)
    return torch.linalg.solve_triangular(
        Aop, alpha * B, upper=upper, left=(side == Side.Left),
        unitriangular=(diag == Diag.Unit),
    )
