"""Level-3 BLAS drivers, the global path of ``trsm`` (reference:
src/trsm.cc).  The other BLAS3 routines and the multi-device paths come
in later slices.
"""

from __future__ import annotations

import torch

from ..aux.metrics import instrumented
from ..enums import Op, Side
from ..matrix.base import BaseMatrix
from ..matrix.matrix import Matrix, TriangularMatrix
from ..ops import blas2d
from ..parallel.layout import tiles_from_global


def _repack_like(C_new_2d: torch.Tensor, C: BaseMatrix) -> BaseMatrix:
    """Pack a computed LOGICAL (m, n) global tensor back into C's
    layout.  For op-views the logical dims are the transpose of the
    storage layout, so the result gets the transposed layout with the op
    resolved away."""
    C_new_2d = C_new_2d.to(C.dtype)
    if C.op != Op.NoTrans:
        lay = C.layout.transposed()
        return Matrix(tiles_from_global(C_new_2d, lay), lay, grid=C.grid)
    return C._with(data=tiles_from_global(C_new_2d, C.layout))


@instrumented("trsm")
def trsm(side: Side, alpha, A: TriangularMatrix, B: Matrix, opts=None) -> Matrix:
    """Solve op(A) X = alpha B (or X op(A) = alpha B) on the global path:
    one library triangular solve (reference: src/trsm.cc)."""
    A2 = A._with(op=Op.NoTrans).to_global()
    out = blas2d.trsm2d(side, A.uplo, A.op, A.diag, alpha, A2, B.to_global())
    return _repack_like(out, B)
