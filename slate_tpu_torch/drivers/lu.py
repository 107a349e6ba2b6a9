"""LU family drivers (reference: src/getrf.cc, getrf_nopiv.cc,
getrf_tntpiv.cc, getrs.cc, getrs_nopiv.cc, gesv.cc, gesv_nopiv.cc,
gesv_rbt.cc + gerbt.cc + internal_rbt_generate.cc, getri.cc,
gecondest.cc, trcondest.cc), the single-device path of the JAX
package's ``drivers/lu.py``.

``getrf`` factors the padded global tensor through the schedule
dispatcher in ops/lu_kernels.py; on a CUDA device at n >= 2048 ``auto``
takes the ``pallas`` family, whose panels run the Hopper ``panel_lu``
kernel.  ``getrs_from_global`` is the solve-only entry point of a factor
cache hit: the Hopper trsm pair on the packed factor.  ``gesv`` with
``MethodLU.RBT`` randomizes with the random butterfly transform (the
Hopper ``butterfly_level`` kernel) and factors without pivoting.
``MethodLU.CALU`` / ``BEAM`` factor with tournament pivoting
(``lu_kernels.blocked_getrf_tntpiv``), whose elections and panel factors
run the ``panel_lu`` kernel on a CUDA device.  ``gecondest`` and
``trcondest`` estimate reciprocal condition numbers with the Hager/Higham
estimator (``internal/norm1est.py``).

On a mesh (``on_mesh``) ``getrf`` runs ``parallel/spmd_lu.py`` (partial
pivoting, or the mesh tournament for CALU / BEAM; the panels through
``panel_lu``), ``getrs`` permutes B's rows and runs the two
``spmd_trsm`` pipelines, and ``gesv`` / ``getri`` go through them; what
does not conform (other tiles, ``Option.UseShardMap`` off, views) is
gathered and recorded as in the JAX package.  The mixed-precision
solvers live in ``drivers/mixed.py`` and are re-exported here
(``gesv_mixed``, ``gesv_mixed_gmres``, and the deprecated
``ir_refine_while``).  The other drivers here gather a distributed
operand in the JAX package and raise for one until ROADMAP.md Queue 1
item 8b2.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple

import torch

from ..aux import metrics
from ..aux.metrics import instrumented
from ..enums import Diag, MethodLU, Norm, Op, Option, Uplo
from ..exceptions import slate_assert
from ..internal import fallbacks
from ..internal.norm1est import rcond
from ..internal.precision import hdot
from ..matrix.base import BaseMatrix, on_mesh, single_device
from ..matrix.matrix import Matrix, TriangularMatrix
from ..matgen.philox import random_torch
from ..ops import lu_kernels
from ..ops.hopper import panel_kernels as pk
from ..options import Options, get_option, resolve_schedule_opts
from ..parallel import collectives, spmd_lu, spmd_trsm
from ..parallel.layout import (TileLayout, eye_splice, index_maps, local_tiles_from_global,
                               tiles_from_global)
from ..types import Pivots
from .aux import norm as _norm
from .chol import _solve_trsm_route


def _padded_global(A: BaseMatrix, splice_diag: bool = True) -> torch.Tensor:
    """A's global tensor padded to whole tiles (P mb, Q nb), with ones on
    the padding diagonal so the padded system stays nonsingular."""
    Ar = A.resolved()
    lay = Ar.layout
    G = Ar.to_global()
    mp, np_ = lay.P * lay.mb, lay.Q * lay.nb
    Gp = torch.nn.functional.pad(G, (0, np_ - lay.n, 0, mp - lay.m))
    if splice_diag:
        idx = torch.arange(min(lay.m, lay.n), min(mp, np_), device=Gp.device)
        Gp[idx, idx] += 1
    return Gp


def _udiag_info(LU: Matrix, lay: TileLayout) -> torch.Tensor:
    """info: 1 when U's diagonal holds an exact zero or a non-finite
    value, else 0 (int32 on LU's device), by a masked reduction over the
    tile storage (on a mesh over each block, then the maximum over the
    ranks: every rank returns the same info)."""
    gr, gc, _ = index_maps(lay, LU.device, LU.grid)
    dmask = (gr == gc) & (gr < min(lay.m, lay.n))
    T = LU.data
    bad = (T == 0) | ~torch.isfinite(T)
    info = torch.where((bad & dmask).any(), 1, 0).to(torch.int32)
    return collectives.pmax(info, LU.grid) if on_mesh(LU) else info


def _method(opts: Optional[Options]) -> MethodLU:
    method = get_option(opts, Option.MethodLU, MethodLU.Auto)
    return MethodLU.from_string(method) if isinstance(method, str) else method


@instrumented("getrf")
def getrf(A: Matrix, opts: Optional[Options] = None) -> Tuple[Matrix, Pivots, torch.Tensor]:
    """LU with partial pivoting: P A = L U (reference: src/getrf.cc).

    Returns (LU, pivots, info): LU holds unit-lower L below the diagonal
    and U on/above (LAPACK layout); pivots is the net forward row
    permutation over the padded rows; info > 0 flags an exactly singular
    U diagonal.  On a mesh with square tiles: ``spmd_lu.spmd_getrf`` or,
    for CALU / BEAM, ``spmd_lu.spmd_getrf_tntpiv``; other tiles or
    ``Option.UseShardMap`` off gather (recorded ``getrf`` /
    ``getrf_tntpiv``, the latter with a warning), as in the JAX package."""
    slate_assert(A.op == Op.NoTrans, "getrf expects a non-transposed view")
    lay = A.layout
    calu = _method(opts) in (MethodLU.CALU, MethodLU.BEAM)
    if on_mesh(A):
        if get_option(opts, Option.UseShardMap) and lay.mb == lay.nb:
            T = eye_splice(lay, A.data, grid=A.grid)
            fn = spmd_lu.spmd_getrf_tntpiv if calu else spmd_lu.spmd_getrf
            Td, perm = fn(A.grid, T, lay)
            LU = A._with(data=Td)
            return LU, Pivots(perm), _udiag_info(LU, lay)
        if calu:
            warnings.warn("getrf(MethodLU.CALU) on a distributed matrix gathers to a global "
                          "array (non-square tiles or UseShardMap disabled)", stacklevel=2)
            fallbacks.record("getrf_tntpiv", opts, "tournament gathers")
        else:
            fallbacks.record("getrf", opts, "non-square tiles")
    Gp = _padded_global(A)
    if calu:
        # tournament pivoting (reference: getrf_tntpiv.cc); BEAM maps to
        # the tournament too
        if metrics.is_on():
            metrics.record_factor_flops("getrf", lu_kernels.tntpiv_schedule_flops(
                *Gp.shape, lay.nb, m_true=lay.m, n_true=lay.n))
        lu2d, perm = lu_kernels.blocked_getrf_tntpiv(Gp, lay.nb)
        LU = A._with(data=local_tiles_from_global(lu2d[: lay.m, : lay.n], lay, A.grid))
        return LU, Pivots(perm), _udiag_info(LU, lay)
    sched, nb_switch, lookahead = resolve_schedule_opts(opts)
    mp, np_ = Gp.shape
    if metrics.is_on():
        route = lu_kernels.resolve_lu_schedule(mp, np_, Gp.dtype, sched, Gp.device)
        metrics.record_factor_flops("getrf", lu_kernels.getrf_schedule_flops(
            mp, np_, lay.nb, route, nb_switch, lookahead, m_true=lay.m, n_true=lay.n))
    lu2d, perm = lu_kernels.lu_global(Gp, lay.nb, sched, nb_switch, lookahead)
    LU = A._with(data=local_tiles_from_global(lu2d[: lay.m, : lay.n], lay, A.grid))
    return LU, Pivots(perm), _udiag_info(LU, lay)


def _nopiv_block(a: torch.Tensor) -> torch.Tensor:
    """Unblocked no-pivot LU of one square tile, column by column."""
    nb = a.shape[0]
    a = a.clone()
    idx = torch.arange(nb, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    for j in range(nb):
        pivot = a[j, j]
        col = a[:, j] / torch.where(pivot == 0, torch.ones_like(pivot), pivot)
        below = idx > j
        lcol = torch.where(below, col, a[:, j] * 0)
        a[:, j] = torch.where(below, lcol, a[:, j])
        a -= torch.outer(lcol, torch.where(below, a[j], zero))
    return a


def _nopiv_blocked(G: torch.Tensor, nb: int) -> torch.Tensor:
    """Right-looking blocked no-pivot LU of a square padded tensor, n a
    multiple of nb: the JAX package's tile loop at exact shapes (its
    masked full-shape steps leave the other entries unchanged)."""
    G = G.clone()
    n = G.shape[0]
    for k0 in range(0, n, nb):
        k1 = k0 + nb
        G[k0:k1, k0:k1] = _nopiv_block(G[k0:k1, k0:k1])
        if k1 < n:
            D = G[k0:k1, k0:k1]
            G[k1:, k0:k1] = torch.linalg.solve_triangular(
                torch.triu(D), G[k1:, k0:k1], upper=True, left=False)
            G[k0:k1, k1:] = torch.linalg.solve_triangular(
                D, G[k0:k1, k1:], upper=False, unitriangular=True)
            G[k1:, k1:] -= hdot(G[k1:, k0:k1], G[k0:k1, k1:])
    return G


@instrumented("getrf_nopiv")
@single_device("8b2")
def getrf_nopiv(A: Matrix, opts: Optional[Options] = None) -> Tuple[Matrix, torch.Tensor]:
    """LU without pivoting (reference: src/getrf_nopiv.cc).  Returns (LU,
    info).  The recursive and pallas routes (``auto`` on a CUDA device at
    n >= 2048 takes pallas) run ``getrf_recursive(pivot=False)``, whose
    panels go through the ``panel_lu`` kernel without its pivot search;
    the other routes run the blocked tile loop."""
    slate_assert(A.m == A.n, "getrf_nopiv requires square A")
    slate_assert(A.layout.mb == A.layout.nb, "getrf_nopiv requires square tiles")
    lay = A.layout
    Gp = _padded_global(A)
    sched, nb_switch, lookahead = resolve_schedule_opts(opts)
    route = lu_kernels.resolve_lu_schedule(*Gp.shape, Gp.dtype, sched, Gp.device)
    if route in ("recursive", "pallas"):
        lu2d, _ = lu_kernels.getrf_recursive(Gp, nb_switch, lookahead, route, pivot=False)
    else:
        lu2d = _nopiv_blocked(Gp, lay.nb)
    LU = A._with(data=tiles_from_global(lu2d[: lay.m, : lay.n], lay))
    return LU, _udiag_info(LU, lay)


def _getrs_spmd_ok(LU: Matrix, pivots: Optional[Pivots], B: Matrix) -> bool:
    lay, layB = LU.layout, B.layout
    return (lay.mb == lay.nb == layB.mb
            and (lay.p, lay.q) == (layB.p, layB.q)
            and layB.mt == lay.mt
            and LU.op == Op.NoTrans and B.op == Op.NoTrans
            and LU.grid == B.grid
            and (pivots is None or pivots.perm.shape[0] == lay.P * lay.mb))


@instrumented("getrs")
def getrs(LU: Matrix, pivots: Optional[Pivots], B: Matrix,
          opts: Optional[Options] = None) -> Matrix:
    """Solve A X = B from getrf factors (reference: src/getrs.cc: rows
    permuted forward, then the unit-lower and the upper solve).  On a
    mesh: ``spmd_trsm.spmd_permute_rows`` and the two ``spmd_trsm_left``
    pipelines over the LU-packed tiles, no gather; a layout or view that
    does not conform (or ``Option.UseShardMap`` off) gathers, recorded
    ``getrs``."""
    if on_mesh(B) and get_option(opts, Option.UseShardMap) and _getrs_spmd_ok(LU, pivots, B):
        lay = LU.layout
        TB = B.data
        if pivots is not None:
            TB = spmd_trsm.spmd_permute_rows(B.grid, TB, B.layout, pivots.perm)
        TT = eye_splice(lay, LU.data, grid=LU.grid)
        Y = spmd_trsm.spmd_trsm_left(B.grid, TT, lay, TB, B.layout, lower=True, trans=False,
                                     conj=False, unit_diag=True)
        X = spmd_trsm.spmd_trsm_left(B.grid, TT, lay, Y, B.layout, lower=False, trans=False,
                                     conj=False, unit_diag=False)
        return B._with(data=X)
    if on_mesh(B):
        fallbacks.record("getrs", opts, "layout/view not spmd-conformable")
    G = LU.to_global()
    B2 = B.to_global()
    if pivots is not None:
        B2 = torch.nn.functional.pad(B2, (0, 0, 0, pivots.perm.shape[0] - B2.shape[0]))
        B2 = pivots.apply(B2)[: B.m]
    Y = torch.linalg.solve_triangular(G, B2, upper=False, unitriangular=True)
    X = torch.linalg.solve_triangular(G, Y, upper=True)
    return B._with(data=local_tiles_from_global(X.to(B.dtype), B.layout, B.grid))


@single_device("8b2")
def getrs_nopiv(LU: Matrix, B: Matrix, opts: Optional[Options] = None) -> Matrix:
    """(reference: src/getrs_nopiv.cc)"""
    return getrs(LU, None, B, opts)


def getrs_from_global(LUg: torch.Tensor, Bg: torch.Tensor,
                      schedule: str = "auto") -> torch.Tensor:
    """Solve-only entry point over global tensors: two trsm sweeps
    against a packed LU (unit-lower L below the diagonal, U on and
    above), B already row-permuted (P B) — the O(n^2) work of a factor
    cache hit.  The ``pallas`` route (``auto`` on a CUDA device at
    n >= 2048) runs both sweeps through the Hopper trsm pair, which
    reads one triangle each, so the packed storage needs no unpacking."""
    if _solve_trsm_route(LUg.shape[0], LUg.dtype, schedule, LUg.device) == "pallas":
        LUg, Bg = LUg.contiguous(), Bg.contiguous()  # the kernels read rows
        Y = pk.trsm_lower(LUg, Bg, unit=True)
        return pk.trsm_upper(LUg, Y)
    Y = torch.linalg.solve_triangular(LUg, Bg, upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(LUg, Y, upper=True)


@instrumented("gesv")
def gesv(A: Matrix, B: Matrix, opts: Optional[Options] = None
         ) -> Tuple[Matrix, Matrix, Pivots, torch.Tensor]:
    """Solve A X = B (reference: src/gesv.cc; MethodLU PartialPiv (the
    default), NoPiv or RBT).  Returns (X, LU, pivots, info)."""
    method = _method(opts)
    if method == MethodLU.NoPiv:
        LU, info = getrf_nopiv(A, opts)
        empty = torch.arange(0, dtype=torch.int32, device=LU.device)
        return getrs_nopiv(LU, B, opts), LU, Pivots(empty), info
    if method == MethodLU.RBT:
        return gesv_rbt(A, B, opts)
    LU, piv, info = getrf(A, opts)
    return getrs(LU, piv, B, opts), LU, piv, info


@single_device("8b2")
def gesv_nopiv(A: Matrix, B: Matrix, opts: Optional[Options] = None):
    """(reference: src/gesv_nopiv.cc)"""
    return gesv(A, B, {**(dict(opts) if opts else {}), Option.MethodLU: MethodLU.NoPiv})


# ---------------------------------------------------------------------------
# Random butterfly transform (reference: src/gerbt.cc,
# src/internal/internal_rbt_generate.cc, gesv_rbt.cc)
# ---------------------------------------------------------------------------


def _butterfly_diags(n: int, depth: int, seed: int, dtype: torch.dtype,
                     device) -> torch.Tensor:
    """(depth, n) random diagonals e^{r/10}, r uniform in (-1, 1) from the
    Philox counter RNG keyed by (level * n + i, 0): the JAX package's
    values (reference: internal_rbt_generate.cc)."""
    i = torch.arange(depth * n, dtype=torch.int64, device=device).reshape(depth, n)
    r = random_torch("uniform_signed", seed, i, torch.zeros_like(i), torch.float64)
    return torch.exp(r / 10.0).to(dtype)


def _apply_butterfly(X: torch.Tensor, diags: torch.Tensor, transpose: bool) -> torch.Tensor:
    """Y = B^T X (transpose=True) or B X, B the recursive butterfly of
    depth d = diags.shape[0]: level ell pairs the rows of each of its 2^ell
    blocks; one ``butterfly_level`` call a level covers all its blocks
    (its plain version for a dtype the kernel does not take)."""
    d, n = diags.shape
    Y = X.contiguous()  # the kernel reads rows with inner stride 1
    level = pk.butterfly_level if X.dtype in pk.KERNEL_DTYPES else pk.butterfly_level_plain
    for ell in (range(d) if transpose else range(d - 1, -1, -1)):
        h = n // (2 * 2**ell)
        if h == 0:
            continue
        Y = level(Y, diags[ell], h, transpose)
    return Y


def _gerbt_full(A: Matrix, depth: int, seed: int):
    """The two-sided butterfly transform of A padded to a power of two.

    Returns (A' of size n2, du, dv, n2).  The whole n2 x n2 transformed
    matrix is kept: the butterfly mixes the identity padding into the
    valid block.  The column transform works on a contiguous transposed
    copy (n2^2 elements)."""
    slate_assert(A.m == A.n, "rbt requires square A")
    n = A.n
    n2 = 1 << math.ceil(math.log2(max(n, 1)))
    G = A.to_global()
    Gp = torch.nn.functional.pad(G, (0, n2 - n, 0, n2 - n))
    idx = torch.arange(n, n2, device=Gp.device)
    Gp[idx, idx] = 1
    du = _butterfly_diags(n2, depth, seed, G.dtype, G.device)
    dv = _butterfly_diags(n2, depth, seed + 1, G.dtype, G.device)
    # A' = U^T A V: columns through U^T on the left, rows through V
    Gp = _apply_butterfly(Gp, du, transpose=True)
    Gp = _apply_butterfly(Gp.T, dv, transpose=True).T
    return Gp, du, dv, n2


@single_device("8b2")
def gerbt(A: Matrix, depth: int = 2, seed: int = 42, opts: Optional[Options] = None):
    """Two-sided random butterfly transform A' = U^T A V (reference:
    src/gerbt.cc); returns (A', diags_U, diags_V)."""
    Gp, du, dv, _ = _gerbt_full(A, depth, seed)
    out = Matrix.from_global(Gp[: A.n, : A.n], A.layout.mb, A.layout.nb, grid=A.grid)
    return out, du, dv


@instrumented("gesv_rbt")
@single_device("8b2")
def gesv_rbt(A: Matrix, B: Matrix, opts: Optional[Options] = None
             ) -> Tuple[Matrix, Matrix, Pivots, torch.Tensor]:
    """RBT solve: butterfly-randomize, factor without pivoting, solve,
    then two steps of iterative refinement (reference: src/gesv_rbt.cc).
    Returns (X, LU of the transformed matrix, empty pivots, info)."""
    depth = int(get_option(opts, Option.Depth, 2))
    seed = 42
    Gp, du, dv, n2 = _gerbt_full(A, depth, seed)
    Arbt = Matrix.from_global(Gp, min(A.layout.mb, n2), grid=A.grid)
    LU, info = getrf_nopiv(Arbt, opts)
    G_lu = LU.to_global()
    A2, B2 = A.to_global(), B.to_global()
    n = A.n

    def solve(Rhs):
        Rp = torch.nn.functional.pad(Rhs, (0, 0, 0, n2 - n))
        Rp = _apply_butterfly(Rp, du, transpose=True)
        Y = torch.linalg.solve_triangular(G_lu, Rp, upper=False, unitriangular=True)
        Z = torch.linalg.solve_triangular(G_lu, Y, upper=True)
        return _apply_butterfly(Z, dv, transpose=False)[:n]

    X = solve(B2)
    for _ in range(2):
        X = X + solve(B2 - hdot(A2, X))
    Xm = B._with(data=tiles_from_global(X.to(B.dtype), B.layout))
    empty = torch.arange(0, dtype=torch.int32, device=X.device)
    return Xm, LU, Pivots(empty), info


@instrumented("getri")
def getri(LU: Matrix, pivots: Pivots, opts: Optional[Options] = None) -> Matrix:
    """Matrix inverse from LU factors (reference: src/getri.cc /
    getriOOP.cc): A^-1 = U^-1 L^-1 P."""
    eye = torch.eye(LU.m, dtype=LU.dtype, device=LU.device)
    return getrs(LU, pivots, Matrix.from_global(eye, LU.layout.mb, LU.layout.nb,
                                                grid=LU.grid), opts)


# Mixed-precision solvers: implementations live in drivers/mixed.py,
# routed through the refine subsystem; re-exported here for the
# reference-parity import paths (lu.gesv_mixed).
from .mixed import gesv_mixed, gesv_mixed_gmres  # noqa: E402,F401

# Back-compat shim for the pre-refine helper name.
from ..refine.ir import ir_refine_while  # noqa: E402,F401


@instrumented("gecondest")
@single_device("8b2")
def gecondest(LU: Matrix, pivots: Pivots, anorm, norm_type: Norm = Norm.One,
              opts=None) -> torch.Tensor:
    """Reciprocal condition estimate from LU factors (reference:
    src/gecondest.cc, through the Hager/Higham estimator of
    internal_norm1est.cc): O(n^2) factor solves instead of an explicit
    inverse."""
    G = LU.to_global()
    n = G.shape[0]
    perm = pivots.perm[:n].long().clamp(0, n - 1)
    inv_perm = torch.zeros(n, dtype=perm.dtype, device=perm.device)
    inv_perm[perm] = torch.arange(n, dtype=perm.dtype, device=perm.device)

    def solve(R):  # A^-1 R  (A = P^T L U)
        Y = torch.linalg.solve_triangular(G, R[perm], upper=False, unitriangular=True)
        return torch.linalg.solve_triangular(G, Y, upper=True)

    def solve_h(R):  # A^-H R
        Y = torch.linalg.solve_triangular(G.mH, R, upper=False)
        Z = torch.linalg.solve_triangular(G.mH, Y, upper=True, unitriangular=True)
        return Z[inv_perm]

    return rcond(anorm, solve, solve_h, n, LU.dtype, norm_type == Norm.Inf, device=G.device)


@single_device("8b2")
def trcondest(T: TriangularMatrix, norm_type: Norm = Norm.One, opts=None) -> torch.Tensor:
    """Triangular reciprocal condition estimate (reference:
    src/trcondest.cc, through internal_norm1est.cc): Hager/Higham on
    op(T)^-1 with O(n^2) solves against the stored triangle, ||T|| from
    ``norm``."""
    anorm = _norm(norm_type, T)
    G = T._with(op=Op.NoTrans).to_global()
    n = G.shape[0]
    st_lower = T.uplo == Uplo.Lower
    unit = T.diag == Diag.Unit
    cplx = T.is_complex

    def tri(R, trans: bool, conj: bool):
        """op(G) X = R, op given in storage terms (trans, conj)."""
        if conj and not trans:  # conj(G) X = R
            return torch.linalg.solve_triangular(
                G, R.conj_physical(), upper=not st_lower,
                unitriangular=unit).conj_physical()
        Gop = (G.mH if conj and cplx else G.T) if trans else G
        return torch.linalg.solve_triangular(Gop, R, upper=st_lower == trans,
                                             unitriangular=unit)

    vt, vc = T.op != Op.NoTrans, T.op == Op.ConjTrans

    def solve(R):
        return tri(R, vt, vc)

    def solve_h(R):
        return tri(R, not vt, cplx and not vc)

    return rcond(anorm, solve, solve_h, n, T.dtype, norm_type == Norm.Inf, device=G.device)
