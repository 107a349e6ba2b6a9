"""Level-3 BLAS drivers, the global path of ``gemm``, ``hemm``/``symm``,
``herk``/``syrk``, ``her2k``/``syr2k``, ``trmm`` and ``trsm`` (reference:
src/gemm.cc, hemm.cc, symm.cc, herk.cc, syrk.cc, her2k.cc, syr2k.cc,
trmm.cc, trsm.cc): the operands as global tensors and one library call,
the best schedule on one device.  The multi-device paths come with the
meshes (ROADMAP.md, Queue 1 item 8).
"""

from __future__ import annotations

import torch

from ..aux.metrics import instrumented
from ..enums import Op, Side, Uplo
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


@instrumented("symm")
def symm(side: Side, alpha, A: SymmetricMatrix, B: Matrix, beta, C: Matrix,
         opts=None) -> Matrix:
    """C = alpha A B + beta C (Side.Left) or alpha B A + beta C
    (Side.Right), A symmetric (reference: src/symm.cc)."""
    _check_hemm_dims(side, A, B, C)
    return _hemm_global(side, alpha, A, B, beta, C)


@instrumented("hemm")
def hemm(side: Side, alpha, A: HermitianMatrix, B: Matrix, beta, C: Matrix,
         opts=None) -> Matrix:
    """C = alpha A B + beta C (Side.Left) or alpha B A + beta C
    (Side.Right), A Hermitian (reference: src/hemm.cc; its method A/C
    variants collapse to one library product)."""
    _check_hemm_dims(side, A, B, C)
    return _hemm_global(side, alpha, A, B, beta, C)


def _hemm_global(side: Side, alpha, A, B: Matrix, beta, C: Matrix) -> Matrix:
    """One product with A's stored triangle mirrored (``full_global``)."""
    Af, B2, C2 = A.full_global(), B.to_global(), C.to_global()
    if side == Side.Left:
        out = blas2d.gemm2d(alpha, Af, B2, beta, C2)
    else:
        out = blas2d.gemm2d(alpha, B2, Af, beta, C2)
    return _repack_like(out, C)


def _check_hemm_dims(side, A, B, C):
    if side == Side.Left:
        ok = A.n == B.m and A.m == C.m and B.n == C.n
    else:
        ok = B.n == A.m and B.m == C.m and A.n == C.n
    if not ok:
        raise DimensionError(f"hemm/symm dims: A {A.m}x{A.n}, B {B.m}x{B.n}, C {C.m}x{C.n}")


def _herk_like(alpha, A: BaseMatrix, beta, C, conj: bool, rank2: bool = False,
               B: BaseMatrix = None) -> BaseMatrix:
    slate_assert(C.m == C.n, "herk/syrk C must be square")
    A2, C2 = A.to_global(), C.full_global()
    if rank2:
        B2 = B.to_global()
        fn = blas2d.her2k2d if conj else blas2d.syr2k2d
        out = fn(alpha, A2, B2, beta, C2)
    else:
        fn = blas2d.herk2d if conj else blas2d.syrk2d
        out = fn(alpha, A2, beta, C2)
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


@instrumented("syr2k")
def syr2k(alpha, A: Matrix, B: Matrix, beta, C: SymmetricMatrix, opts=None):
    """C = alpha (A B^T + B A^T) + beta C (reference: src/syr2k.cc)."""
    if A.m != C.m or B.m != C.m or A.n != B.n:
        raise DimensionError("syr2k dims")
    return _herk_like(alpha, A, beta, C, conj=False, rank2=True, B=B)


@instrumented("her2k")
def her2k(alpha, A: Matrix, B: Matrix, beta, C: HermitianMatrix, opts=None):
    """C = alpha A B^H + conj(alpha) B A^H + beta C (reference: src/her2k.cc)."""
    if A.m != C.m or B.m != C.m or A.n != B.n:
        raise DimensionError("her2k dims")
    return _herk_like(alpha, A, beta, C, conj=True, rank2=True, B=B)


def _resolve_tri(A: TriangularMatrix):
    """Triangular operand as (storage global tensor, the uplo of op(A),
    op), honoring A.op."""
    op = A.op
    uplo = A.uplo
    if op != Op.NoTrans:
        uplo = Uplo.Upper if A.uplo == Uplo.Lower else Uplo.Lower
    return A._with(op=Op.NoTrans).to_global(), uplo, op


@instrumented("trmm")
def trmm(side: Side, alpha, A: TriangularMatrix, B: Matrix, opts=None) -> Matrix:
    """B = alpha op(A) B (Side.Left) or alpha B op(A) (Side.Right)
    (reference: src/trmm.cc): one library product with the stored
    triangle of A (a unit diagonal read as ones)."""
    A2 = A._with(op=Op.NoTrans).to_global()
    out = blas2d.trmm2d(side, A.uplo, A.op, A.diag, alpha, A2, B.to_global())
    return _repack_like(out, B)
