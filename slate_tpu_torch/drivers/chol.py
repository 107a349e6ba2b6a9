"""Cholesky family drivers (reference: src/potrf.cc, potrs.cc, posv.cc).

``potrf`` factors on the global path through the schedule dispatcher in
ops/chol_kernels.py; on a CUDA device at n >= 2048 ``auto`` takes the
``pallas`` family, i.e. the Hopper kernels.  ``potrs_from_global`` is
the solve-only entry point of a factor cache hit.  ``trtri`` and
``potri`` invert through ``chol_kernels.tri_inv_blocked``, ``trtrm``
is one product; ``pocondest`` estimates the reciprocal condition number
with the Hager/Higham estimator (``internal/norm1est.py``).
``posv_mixed`` and ``posv_mixed_gmres`` (``drivers/mixed.py``) are
re-exported here.

On a mesh (``on_mesh``) ``potrf`` runs ``parallel/spmd_chol.py`` (each
diagonal tile through the Hopper kernels on a CUDA device) and
``potrs`` / ``posv`` solve through the mesh ``trsm``; the other drivers
here gather a distributed operand in the JAX package and raise for one
until ROADMAP.md Queue 1 item 8b2.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..aux import metrics
from ..aux.metrics import instrumented
from ..enums import Diag, Op, Option, Side, Uplo
from ..exceptions import slate_assert
from ..internal import fallbacks
from ..internal.norm1est import rcond
from ..internal.precision import hdot
from ..matrix.base import conj_transpose, on_mesh, single_device
from ..matrix.matrix import HermitianMatrix, Matrix, TriangularMatrix
from ..ops import chol_kernels
from ..ops.hopper import panel_kernels as pk
from ..options import Options, get_option, resolve_schedule_opts
from ..parallel import collectives, spmd_chol
from ..parallel.layout import eye_splice, local_tiles_from_global
from . import blas3


@instrumented("potrf")
def potrf(A: HermitianMatrix, opts: Optional[Options] = None
          ) -> Tuple[TriangularMatrix, torch.Tensor]:
    """Cholesky: A = L L^H (uplo Lower) or U^H U (Upper)
    (reference: src/potrf.cc:84-209).

    Returns (factor, info); info > 0 signals a non-SPD matrix, detected
    from non-finite entries of the factor (an int32 tensor on A's device;
    on a mesh the maximum over its ranks, the same on each).  On a mesh
    ``spmd_chol.spmd_potrf_lower`` reads the stored lower triangle; an
    Upper or viewed A is mirrored first (recorded ``potrf.mirror``), and
    with ``Option.UseShardMap`` off the call gathers (recorded ``potrf``).
    """
    slate_assert(A.m == A.n, "potrf requires square A")
    slate_assert(A.layout.mb == A.layout.nb, "potrf requires square tiles")
    lay = A.layout
    sched, nb_switch, lookahead = resolve_schedule_opts(opts)
    if on_mesh(A) and get_option(opts, Option.UseShardMap):
        if A.uplo == Uplo.Lower and A.op == Op.NoTrans:
            T = A.data  # the stored lower triangle is all the mesh path reads
        else:
            fallbacks.record("potrf.mirror", opts, "upper/viewed Hermitian mirrors globally")
            T = local_tiles_from_global(A.full_global().to(A.dtype), lay, A.grid)
        T = eye_splice(lay, T, grid=A.grid)
        Ld = spmd_chol.spmd_potrf_lower(A.grid, T, lay, sched, nb_switch, lookahead)
        L = TriangularMatrix(Ld, lay, grid=A.grid, uplo=Uplo.Lower)
    else:
        if on_mesh(A):
            fallbacks.record("potrf", opts, "UseShardMap disabled")
        full = A.full_global()
        n = A.n
        nb_kernel = 512 if n >= 2048 else min(lay.nb, 512)
        if metrics.is_on():
            route = chol_kernels.resolve_schedule(n, full.dtype, sched, full.device)
            metrics.record_factor_flops(
                "potrf",
                chol_kernels.chol_schedule_flops(n, nb_kernel, route, nb_switch, lookahead),
            )
        L2 = chol_kernels.cholesky(full, nb_kernel, sched, nb_switch, lookahead)
        L = TriangularMatrix.from_global(L2, lay.mb, lay.nb, grid=A.grid, uplo=Uplo.Lower)
    info = torch.where(torch.isfinite(L.data).all(), 0, 1).to(torch.int32)
    if on_mesh(A):
        info = collectives.pmax(info, A.grid)
    if A.uplo == Uplo.Upper:
        U = conj_transpose(L).resolved()
        return TriangularMatrix(U.data, U.layout, grid=U.grid, uplo=Uplo.Upper), info
    return L, info


@instrumented("potrs")
def potrs(L: TriangularMatrix, B: Matrix, opts: Optional[Options] = None) -> Matrix:
    """Solve A X = B given the Cholesky factor (reference: src/potrs.cc:
    two trsm sweeps)."""
    if L.uplo == Uplo.Lower:
        Y = blas3.trsm(Side.Left, 1.0, L, B, opts)
        return blas3.trsm(Side.Left, 1.0, conj_transpose(L), Y, opts)
    Y = blas3.trsm(Side.Left, 1.0, conj_transpose(L), B, opts)
    return blas3.trsm(Side.Left, 1.0, L, Y, opts)


def _solve_trsm_route(n: int, dtype, schedule: str, device="cpu") -> str:
    """Route of the solve-phase trsm pair: explicit ``pallas`` everywhere
    (the kernels' plain versions on the CPU); ``auto`` takes the Hopper
    pair on a CUDA device above the factor crossover, the library solve
    otherwise.  A dtype the kernels do not take on a CUDA device
    (complex) takes the library solve."""
    if not pk.kernels_take(dtype, device):
        return "vendor"
    if schedule == "pallas":
        return "pallas"
    if (schedule == "auto" and torch.device(device).type != "cpu"
            and n >= chol_kernels.RECURSIVE_MIN_N):
        return "pallas"
    return "vendor"


def potrs_from_global(Lg: torch.Tensor, Bg: torch.Tensor,
                      schedule: str = "auto") -> torch.Tensor:
    """Solve L L^H X = B by two trsm sweeps against a lower-triangular
    factor given as a global tensor (only its lower triangle is read):
    the O(n^2) kernel of a factor cache hit.  The ``pallas`` route runs
    both sweeps through the Hopper trsm pair; the backward sweep reads L
    as L^H without a transposed copy."""
    if _solve_trsm_route(Lg.shape[0], Lg.dtype, schedule, Lg.device) == "pallas":
        Lg, Bg = Lg.contiguous(), Bg.contiguous()  # the kernels read rows
        Y = pk.trsm_lower(Lg, Bg)
        return pk.trsm_upper(Lg, Y, transposed=True)
    Y = torch.linalg.solve_triangular(Lg, Bg, upper=False)
    return torch.linalg.solve_triangular(Lg.mH, Y, upper=True)


@instrumented("posv")
def posv(A: HermitianMatrix, B: Matrix, opts: Optional[Options] = None
         ) -> Tuple[Matrix, TriangularMatrix, torch.Tensor]:
    """Solve SPD A X = B (reference: src/posv.cc = potrf + potrs).

    Returns (X, factor, info)."""
    L, info = potrf(A, opts)
    X = potrs(L, B, opts)
    return X, L, info


@instrumented("trtri")
@single_device("8b2")
def trtri(T: TriangularMatrix, opts: Optional[Options] = None) -> TriangularMatrix:
    """Triangular inverse (reference: src/trtri.cc) by
    ``chol_kernels.tri_inv_blocked``: the stored triangle (a unit
    diagonal read as ones; Upper through its transpose) inverted by
    recursive 2x2 blocking.  op(T)^-1 lives in the triangle of op(T),
    not of the storage: a transposed view inverts into the other
    triangle."""
    slate_assert(T.m == T.n, "trtri requires square")
    A2, out_uplo, op = blas3._resolve_tri(T)
    lower = torch.tril(A2) if T.uplo == Uplo.Lower else torch.triu(A2).mT
    if T.diag == Diag.Unit:
        lower.diagonal().fill_(1)
    inv = chol_kernels.tri_inv_blocked(lower)  # T^-1, or T^-T when Upper
    if T.uplo == Uplo.Upper:
        inv = inv.mT
    if op == Op.Trans:
        inv = inv.mT
    elif op == Op.ConjTrans:
        inv = inv.mH
    return TriangularMatrix.from_global(inv, T.layout.mb, T.layout.nb, grid=T.grid,
                                        uplo=out_uplo, diag=T.diag)


@single_device("8b2")
def trtrm(L: TriangularMatrix, opts: Optional[Options] = None) -> HermitianMatrix:
    """L^H L (Lower) or U U^H (Upper) of the stored triangle, the second
    half of potri (reference: src/trtrm.cc)."""
    Lg = L._with(op=Op.NoTrans).to_global()
    if L.uplo == Uplo.Lower:
        tri = torch.tril(Lg)
        out = hdot(tri.mH, tri)
    else:
        tri = torch.triu(Lg)
        out = hdot(tri, tri.mH)
    return HermitianMatrix.from_global(out, L.layout.mb, L.layout.nb, grid=L.grid,
                                       uplo=L.uplo)


@instrumented("potri")
@single_device("8b2")
def potri(L: TriangularMatrix, opts: Optional[Options] = None) -> HermitianMatrix:
    """SPD inverse from the Cholesky factor: A^-1 = L^-H L^-1
    (reference: src/potri.cc = trtri + trtrm)."""
    return trtrm(trtri(L, opts), opts)


# Mixed-precision SPD solvers: implementations live in drivers/mixed.py,
# re-exported here for the reference-parity import paths
# (chol.posv_mixed).
from .mixed import posv_mixed, posv_mixed_gmres  # noqa: E402,F401


@single_device("8b2")
def pocondest(L: TriangularMatrix, anorm, opts: Optional[Options] = None) -> torch.Tensor:
    """Reciprocal condition estimate from the Cholesky factor (reference:
    src/pocondest.cc, through the Hager/Higham estimator of
    internal_norm1est.cc): O(n^2) factor solves a probe instead of the
    O(n^3) explicit inverse.  A^-1 is self-adjoint, so one solve serves
    both directions."""
    G = L._with(op=Op.NoTrans).to_global()
    lower = L.uplo == Uplo.Lower

    def solve(R):
        if lower:  # L L^H X = R
            Y = torch.linalg.solve_triangular(G, R, upper=False)
            return torch.linalg.solve_triangular(G.mH, Y, upper=True)
        Y = torch.linalg.solve_triangular(G.mH, R, upper=False)  # U^H U X = R
        return torch.linalg.solve_triangular(G, Y, upper=True)

    return rcond(anorm, solve, solve, G.shape[0], L.dtype, device=G.device)
