"""Level-3 BLAS drivers, the global path of ``gemm``, ``herk``, ``syrk``
and ``trsm`` (reference: src/gemm.cc, herk.cc, syrk.cc, trsm.cc): the
operands as global tensors and one library call, the best schedule on
one device.  ``hemm``/``symm``, ``her2k``/``syr2k``, ``trmm`` and the
multi-device paths come in later slices.
"""

from __future__ import annotations

import torch

from ..aux.metrics import instrumented
from ..enums import Op, Side
from ..exceptions import DimensionError, slate_assert
from ..matrix.base import BaseMatrix
from ..matrix.matrix import HermitianMatrix, Matrix, SymmetricMatrix, TriangularMatrix
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


@instrumented("gemm")
def gemm(alpha, A: Matrix, B: Matrix, beta, C: Matrix, opts=None) -> Matrix:
    """C = alpha op(A) op(B) + beta C (reference: src/gemm.cc:82), one
    library product."""
    if A.n != B.m or A.m != C.m or B.n != C.n:
        raise DimensionError(f"gemm dims: A {A.m}x{A.n}, B {B.m}x{B.n}, C {C.m}x{C.n}")
    out = blas2d.gemm2d(alpha, A.to_global(), B.to_global(), beta, C.to_global())
    return _repack_like(out, C)


def _herk_like(alpha, A: BaseMatrix, beta, C, conj: bool) -> BaseMatrix:
    slate_assert(C.m == C.n, "herk/syrk C must be square")
    A2, C2 = A.to_global(), C.full_global()
    out = blas2d.herk2d(alpha, A2, beta, C2) if conj else blas2d.syrk2d(alpha, A2, beta, C2)
    return _repack_like(out, C)


@instrumented("syrk")
def syrk(alpha, A: Matrix, beta, C: SymmetricMatrix, opts=None):
    """C = alpha op(A) op(A)^T + beta C (reference: src/syrk.cc)."""
    if A.m != C.m:
        raise DimensionError(f"syrk dims: A {A.m}x{A.n}, C {C.m}x{C.n}")
    return _herk_like(alpha, A, beta, C, conj=False)


@instrumented("herk")
def herk(alpha, A: Matrix, beta, C: HermitianMatrix, opts=None):
    """C = alpha op(A) op(A)^H + beta C (reference: src/herk.cc)."""
    if A.m != C.m:
        raise DimensionError(f"herk dims: A {A.m}x{A.n}, C {C.m}x{C.n}")
    return _herk_like(alpha, A, beta, C, conj=True)
