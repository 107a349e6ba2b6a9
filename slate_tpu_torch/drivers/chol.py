"""Cholesky family drivers (reference: src/potrf.cc, potrs.cc, posv.cc).

``potrf`` factors on the global path through the schedule dispatcher in
ops/chol_kernels.py; on a CUDA device at n >= 2048 ``auto`` takes the
``pallas`` family, i.e. the Hopper kernels.  ``potrs_from_global`` is
the solve-only entry point of a factor cache hit.  ``trtri``, ``potri``,
``pocondest`` and the mixed-precision drivers come in later slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..aux import metrics
from ..aux.metrics import instrumented
from ..enums import Side, Uplo
from ..exceptions import slate_assert
from ..matrix.base import conj_transpose
from ..matrix.matrix import HermitianMatrix, Matrix, TriangularMatrix
from ..ops import chol_kernels
from ..ops.hopper import panel_kernels as pk
from ..options import Options, resolve_schedule_opts
from . import blas3


@instrumented("potrf")
def potrf(A: HermitianMatrix, opts: Optional[Options] = None
          ) -> Tuple[TriangularMatrix, torch.Tensor]:
    """Cholesky: A = L L^H (uplo Lower) or U^H U (Upper)
    (reference: src/potrf.cc:84-209).

    Returns (factor, info); info > 0 signals a non-SPD matrix, detected
    from non-finite entries of the factor (an int32 tensor on A's device).
    """
    slate_assert(A.m == A.n, "potrf requires square A")
    slate_assert(A.layout.mb == A.layout.nb, "potrf requires square tiles")
    full = A.full_global()
    n = A.n
    lay = A.layout
    sched, nb_switch, lookahead = resolve_schedule_opts(opts)
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
    if A.uplo == Uplo.Upper:
        U = conj_transpose(L).resolved()
        return TriangularMatrix(U.data, U.layout, grid=A.grid, uplo=Uplo.Upper), info
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
