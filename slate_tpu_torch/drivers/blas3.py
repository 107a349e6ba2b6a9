"""Level-3 BLAS drivers: ``gemm``, ``hemm``/``symm``, ``herk``/``syrk``,
``her2k``/``syr2k``, ``trmm`` and ``trsm`` (reference: src/gemm.cc,
gemmA.cc, gemmC.cc, hemm.cc, symm.cc, herk.cc, syrk.cc, her2k.cc,
syr2k.cc, trmm.cc, trsm.cc).  Functional API: every routine returns the
updated output matrix.

Two paths, selected per call, as in the JAX package:

* **global path** (one device): the operands as global tensors and one
  library call, the best schedule on one device;
* **spmd path** (a mesh of more than one process,
  ``ProcessGrid.from_ranks``): the explicit SUMMA / stationary-A /
  triangle-aware kernels of ``parallel/spmd_blas.py`` on each rank's
  tile block.  An operand the spmd kernels cannot take (tile sizes,
  grids or views that do not conform) takes the gathered route: every
  rank gathers the operands, computes the global path and keeps its
  block, recorded by ``internal/fallbacks.py`` at the JAX package's
  sites under its route names.  The port has no GSPMD, so the BLAS3
  other than trsm do not read ``Option.UseShardMap``: a distributed
  operand always takes the spmd kernels or the recorded gathered route.

``trsm`` on a mesh (any mesh, a one-process one included: ``on_mesh``)
runs the row or column pipeline of ``parallel/spmd_trsm.py``; with
``Option.UseShardMap`` off, or a B that does not conform (a view, other
tiles or another grid), it records its gather as the JAX package does.
Method auto-selection mirrors gemm.cc:12-24: stationary-C unless A is
much taller than C is wide.
"""

from __future__ import annotations

import torch

from ..aux.metrics import instrumented
from ..enums import Diag, MethodGemm, Op, Option, Side, Uplo
from ..exceptions import DimensionError, slate_assert
from ..internal import fallbacks
from ..matrix.base import BaseMatrix, is_distributed, on_mesh
from ..matrix.matrix import HermitianMatrix, Matrix, SymmetricMatrix, TriangularMatrix
from ..ops import blas2d
from ..options import get_option
from ..parallel import spmd_blas, spmd_trsm
from ..parallel.layout import eye_splice, local_tiles, tiles_from_global


def _repack_like(C_new_2d: torch.Tensor, C: BaseMatrix) -> BaseMatrix:
    """Pack a computed LOGICAL (m, n) global tensor back into C's
    layout.  For op-views the logical dims are the transpose of the
    storage layout, so the result gets the transposed layout with the op
    resolved away (on a mesh: on the grid ``resolved()`` would put it on,
    this rank keeping its block)."""
    C_new_2d = C_new_2d.to(C.dtype)
    grid, lay = C.grid, C.layout
    if C.op != Op.NoTrans:
        lay = lay.transposed()
        if is_distributed(C) and grid.p != grid.q:
            grid = grid.transposed()
    T = local_tiles(tiles_from_global(C_new_2d, lay), lay, grid)
    if C.op != Op.NoTrans:
        return Matrix(T, lay, grid=grid)
    return C._with(data=T)


def _same_mesh(*mats) -> bool:
    """The operands' tiles are spread over one mesh, each at its place."""
    return all(M.grid == mats[0].grid for M in mats)


def _trsm_spmd_ok(side: Side, A: TriangularMatrix, B: Matrix) -> bool:
    """Whether the trsm pipelines take A and B: square tiles of A's
    storage matching B's along the solved side, one grid, B not a view."""
    layT, layB = A.layout, B.layout
    bdim_b, bt = (layB.mb, layB.mt) if side == Side.Left else (layB.nb, layB.nt)
    return (
        layT.m == layT.n
        and layT.mb == layT.nb == bdim_b
        and (layT.p, layT.q) == (layB.p, layB.q)
        and layT.nt == bt
        and B.op == Op.NoTrans
        and _same_mesh(A, B)
    )


@instrumented("trsm")
def trsm(side: Side, alpha, A: TriangularMatrix, B: Matrix, opts=None) -> Matrix:
    """Solve op(A) X = alpha B (or X op(A) = alpha B) (reference:
    src/trsm.cc -> trsmA/trsmB).  Global path: one library triangular
    solve.  On a mesh: the row pipeline (left) or its column dual (right)
    of ``parallel/spmd_trsm.py``, no gather of A or B."""
    if on_mesh(B) and get_option(opts, Option.UseShardMap) and _trsm_spmd_ok(side, A, B):
        TT = eye_splice(A.layout, A.data, grid=A.grid)
        fn = spmd_trsm.spmd_trsm_left if side == Side.Left else spmd_trsm.spmd_trsm_right
        data = fn(B.grid, TT, A.layout, B.data, B.layout, lower=A.uplo == Uplo.Lower,
                  trans=A.op != Op.NoTrans, conj=A.op == Op.ConjTrans,
                  unit_diag=A.diag == Diag.Unit, alpha=alpha)
        return B._with(data=data)
    if on_mesh(B):
        fallbacks.record("trsm", opts, "right side / transposed B / non-conformable tiles")
    A2 = A._with(op=Op.NoTrans).to_global()
    out = blas2d.trsm2d(side, A.uplo, A.op, A.diag, alpha, A2, B.to_global())
    return _repack_like(out, B)


@instrumented("gemm")
def gemm(alpha, A: Matrix, B: Matrix, beta, C: Matrix, opts=None) -> Matrix:
    """C = alpha op(A) op(B) + beta C (reference: src/gemm.cc:82): one
    library product, or on a mesh stationary-A when A's k dimension is
    small and C narrow, else stationary-C (SUMMA)."""
    if A.n != B.m or A.m != C.m or B.n != C.n:
        raise DimensionError(f"gemm dims: A {A.m}x{A.n}, B {B.m}x{B.n}, C {C.m}x{C.n}")
    method = get_option(opts, Option.MethodGemm, MethodGemm.Auto)
    if isinstance(method, str):
        method = MethodGemm.from_string(method)
    if is_distributed(C):
        Ar, Br = A.resolved(), B.resolved()
        if method == MethodGemm.Auto:
            # gemm.cc:12-24: gemmA when A stays put profitably
            method = (MethodGemm.A
                      if (C.layout.nt <= C.grid.q and Ar.layout.mt > 2 * C.layout.nt)
                      else MethodGemm.C)
        # tile-size conformability for the tile-level spmd kernels
        ok_tiles = (
            Ar.layout.nb == Br.layout.mb
            and Ar.layout.mb == C.layout.mb
            and Br.layout.nb == C.layout.nb
            and (Ar.layout.p, Ar.layout.q) == (C.layout.p, C.layout.q)
            and (Br.layout.p, Br.layout.q) == (C.layout.p, C.layout.q)
            and _same_mesh(Ar, Br, C)
        )
        if ok_tiles:
            fn = spmd_blas.gemm_reduce_a if method == MethodGemm.A else spmd_blas.summa_gemm
            data = fn(C.grid, alpha, Ar.data, Ar.layout, Br.data, Br.layout,
                      beta, C.data, C.layout)
            return C._with(data=data)
        fallbacks.record("gemm", opts, "tile-size/grid mismatch")
    out = blas2d.gemm2d(alpha, A.to_global(), B.to_global(), beta, C.to_global())
    return _repack_like(out, C)


@instrumented("symm")
def symm(side: Side, alpha, A: SymmetricMatrix, B: Matrix, beta, C: Matrix,
         opts=None) -> Matrix:
    """C = alpha A B + beta C (Side.Left) or alpha B A + beta C
    (Side.Right), A symmetric (reference: src/symm.cc)."""
    _check_hemm_dims(side, A, B, C)
    out = _hemm_spmd(side, alpha, A, B, beta, C, opts)
    if out is not None:
        return out
    if is_distributed(C):
        fallbacks.record("symm", opts, "shape/grid not spmd-conformable")
    return _hemm_global(side, alpha, A, B, beta, C)


@instrumented("hemm")
def hemm(side: Side, alpha, A: HermitianMatrix, B: Matrix, beta, C: Matrix,
         opts=None) -> Matrix:
    """C = alpha A B + beta C (Side.Left) or alpha B A + beta C
    (Side.Right), A Hermitian (reference: src/hemm.cc; its method A/C
    variants collapse to one library product; on a mesh the Hermitian
    SUMMA over the stored triangle)."""
    _check_hemm_dims(side, A, B, C)
    out = _hemm_spmd(side, alpha, A, B, beta, C, opts)
    if out is not None:
        return out
    if is_distributed(C):
        fallbacks.record("hemm", opts, "shape/grid not spmd-conformable")
    return _hemm_global(side, alpha, A, B, beta, C)


def _hemm_global(side: Side, alpha, A, B: Matrix, beta, C: Matrix) -> Matrix:
    """One product with A's stored triangle mirrored (``full_global``)."""
    Af, B2, C2 = A.full_global(), B.to_global(), C.to_global()
    if side == Side.Left:
        out = blas2d.gemm2d(alpha, Af, B2, beta, C2)
    else:
        out = blas2d.gemm2d(alpha, B2, Af, beta, C2)
    return _repack_like(out, C)


def _hemm_spmd(side, alpha, A, B, beta, C, opts):
    """Distributed hemm/symm via the Hermitian SUMMA (reference: hemmA's
    broadcast/reduce DAG, src/hemmA.cc): the op-full panel of A is
    assembled per step from the STORED triangle's column and row panels,
    no ``full_global`` mirror.  None when the operands do not conform."""
    if not is_distributed(C):
        return None
    if C.op != Op.NoTrans or A.op != Op.NoTrans:
        return None
    Br = B.resolved()
    layA, layB, layC = A.layout, Br.layout, C.layout
    # conformability on the RESOLVED operand layouts
    if side == Side.Left:
        ok = layB.mb == layA.nb and layB.nb == layC.nb and layA.mb == layC.mb
    else:
        ok = layB.nb == layA.mb and layB.mb == layC.mb and layA.nb == layC.nb
    if not (ok and layA.mb == layA.nb
            and (layA.p, layA.q) == (layC.p, layC.q) == (layB.p, layB.q)
            and _same_mesh(A, Br, C)):
        return None
    data = spmd_blas.spmd_hemm(
        C.grid, side == Side.Left, alpha, A.data, layA, A.uplo == Uplo.Lower,
        Br.data, Br.layout, beta, C.data, layC,
        # complex SYMMETRIC operands mirror without conjugation
        hermitian=isinstance(A, HermitianMatrix))
    return C._with(data=data)


def _check_hemm_dims(side, A, B, C):
    if side == Side.Left:
        ok = A.n == B.m and A.m == C.m and B.n == C.n
    else:
        ok = B.n == A.m and B.m == C.m and A.n == C.n
    if not ok:
        raise DimensionError(f"hemm/symm dims: A {A.m}x{A.n}, B {B.m}x{B.n}, C {C.m}x{C.n}")


def _herk_like_spmd(alpha, A, beta, C, conj: bool, rank2=False, B=None):
    """Distributed rank-k update through ``spmd_blas.spmd_herk`` (the
    reference's internal::herk batched symmetric update): no transposed
    operand is resolved (it would live on the transposed grid) and C's
    stored triangle needs no mirror.  None if shapes or ops do not
    conform (the caller records the fallback)."""
    if C.op != Op.NoTrans:
        return None
    # op(A): NoTrans; ConjTrans with herk (A^H A); Trans with syrk (A^T A)
    if A.op == Op.NoTrans:
        trans = False
    elif (A.op == Op.ConjTrans and conj) or (A.op == Op.Trans and not conj):
        trans = True
    else:
        return None
    lay, layC = A.layout, C.layout  # storage layout (op applies logically)
    nt_match = (lay.nt if trans else lay.mt) == layC.mt
    if not (nt_match and (lay.nb if trans else lay.mb) == layC.mb and layC.mb == layC.nb
            and (lay.p, lay.q) == (layC.p, layC.q) and _same_mesh(A, C)):
        return None
    TB = layB = None
    if rank2:
        if B.op != A.op:
            return None
        layB = B.layout
        if not (layB.mb == lay.mb and layB.nb == lay.nb
                and (layB.p, layB.q) == (layC.p, layC.q) and _same_mesh(B, C)):
            return None
        TB = B.data
    a2 = complex(alpha).conjugate() if (conj and C.is_complex) else alpha
    out = spmd_blas.spmd_herk(C.grid, alpha, A.data, lay, beta, C.data, layC, conj=conj,
                              trans=trans, alpha2=a2, TB=TB, layB=layB,
                              lower=(C.uplo == Uplo.Lower))
    return C._with(data=out)


def _herk_like(alpha, A: BaseMatrix, beta, C, conj: bool, rank2: bool = False,
               B: BaseMatrix = None, opts=None) -> BaseMatrix:
    slate_assert(C.m == C.n, "herk/syrk C must be square")
    if is_distributed(C):
        spmd = _herk_like_spmd(alpha, A, beta, C, conj, rank2, B)
        if spmd is not None:
            return spmd
        fallbacks.record("her2k" if rank2 else "herk", opts, "shape/grid not conformable")
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
    return _herk_like(alpha, A, beta, C, conj=False, opts=opts)


@instrumented("herk")
def herk(alpha, A: Matrix, beta, C: HermitianMatrix, opts=None):
    """C = alpha op(A) op(A)^H + beta C (reference: src/herk.cc)."""
    if A.m != C.m:
        raise DimensionError(f"herk dims: A {A.m}x{A.n}, C {C.m}x{C.n}")
    return _herk_like(alpha, A, beta, C, conj=True, opts=opts)


@instrumented("syr2k")
def syr2k(alpha, A: Matrix, B: Matrix, beta, C: SymmetricMatrix, opts=None):
    """C = alpha (A B^T + B A^T) + beta C (reference: src/syr2k.cc)."""
    if A.m != C.m or B.m != C.m or A.n != B.n:
        raise DimensionError("syr2k dims")
    return _herk_like(alpha, A, beta, C, conj=False, rank2=True, B=B, opts=opts)


@instrumented("her2k")
def her2k(alpha, A: Matrix, B: Matrix, beta, C: HermitianMatrix, opts=None):
    """C = alpha A B^H + conj(alpha) B A^H + beta C (reference: src/her2k.cc)."""
    if A.m != C.m or B.m != C.m or A.n != B.n:
        raise DimensionError("her2k dims")
    return _herk_like(alpha, A, beta, C, conj=True, rank2=True, B=B, opts=opts)


def _resolve_tri(A: TriangularMatrix):
    """Triangular operand as (storage global tensor, the uplo of op(A),
    op), honoring A.op."""
    op = A.op
    uplo = A.uplo
    if op != Op.NoTrans:
        uplo = Uplo.Upper if A.uplo == Uplo.Lower else Uplo.Lower
    return A._with(op=Op.NoTrans).to_global(), uplo, op


def _trmm_spmd_ok(side: Side, A: TriangularMatrix, B: Matrix) -> bool:
    layA, layB = A.layout, B.layout
    bdim_b, bt = (layB.mb, layB.mt) if side == Side.Left else (layB.nb, layB.nt)
    return (
        layA.m == layA.n
        and layA.mb == layA.nb == bdim_b
        and layA.nt == bt
        and (layA.p, layA.q) == (layB.p, layB.q)
        and B.op == Op.NoTrans
        and _same_mesh(A, B)
    )


@instrumented("trmm")
def trmm(side: Side, alpha, A: TriangularMatrix, B: Matrix, opts=None) -> Matrix:
    """B = alpha op(A) B (Side.Left) or alpha B op(A) (Side.Right)
    (reference: src/trmm.cc): one library product with the stored
    triangle of A (a unit diagonal read as ones); on a mesh the
    triangular SUMMA of ``spmd_blas.spmd_trmm``, no gather of A or B."""
    if is_distributed(B) and _trmm_spmd_ok(side, A, B):
        data = spmd_blas.spmd_trmm(
            B.grid, side == Side.Left, alpha, A.data, A.layout,
            lower=A.uplo == Uplo.Lower, unit_diag=A.diag == Diag.Unit,
            opa_trans=A.op != Op.NoTrans, opa_conj=A.op == Op.ConjTrans,
            TB=B.data, layB=B.layout)
        return B._with(data=data)
    if is_distributed(B):
        fallbacks.record("trmm", opts, "shape/grid/view not spmd-conformable")
    A2 = A._with(op=Op.NoTrans).to_global()
    out = blas2d.trmm2d(side, A.uplo, A.op, A.diag, alpha, A2, B.to_global())
    return _repack_like(out, B)
