"""LU family drivers (reference: src/getrf.cc, getrf_nopiv.cc, getrs.cc,
getrs_nopiv.cc, gesv.cc, gesv_nopiv.cc, gesv_rbt.cc + gerbt.cc +
internal_rbt_generate.cc, getri.cc), the single-device path of the JAX
package's ``drivers/lu.py``.

``getrf`` factors the padded global tensor through the schedule
dispatcher in ops/lu_kernels.py; on a CUDA device at n >= 2048 ``auto``
takes the ``pallas`` family, whose panels run the Hopper ``panel_lu``
kernel.  ``getrs_from_global`` is the solve-only entry point of a factor
cache hit: the Hopper trsm pair on the packed factor.  ``gesv`` with
``MethodLU.RBT`` randomizes with the random butterfly transform (the
Hopper ``butterfly_level`` kernel) and factors without pivoting.

Not ported yet: tournament pivoting (``MethodLU.CALU`` / ``BEAM``,
which raise), ``gecondest`` / ``trcondest`` (the norm slice), the mixed
precision re-exports, and the mesh paths.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..aux import metrics
from ..aux.metrics import instrumented
from ..enums import MethodLU, Op, Option
from ..exceptions import slate_assert
from ..internal.precision import hdot
from ..matrix.base import BaseMatrix
from ..matrix.matrix import Matrix
from ..matgen.philox import random_torch
from ..ops import lu_kernels
from ..ops.hopper import panel_kernels as pk
from ..options import Options, get_option, resolve_schedule_opts
from ..parallel.layout import TileLayout, tiles_from_global
from ..types import Pivots
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
    tile storage."""
    dmin = min(lay.m, lay.n)
    dev = LU.data.device
    gr = torch.as_tensor(lay.global_rows_np, device=dev)[:, None, :, None]
    gc = torch.as_tensor(lay.global_cols_np, device=dev)[None, :, None, :]
    dmask = (gr == gc) & (gr < dmin)
    T = LU.data
    bad = (T == 0) | ~torch.isfinite(T)
    return torch.where((bad & dmask).any(), 1, 0).to(torch.int32)


def _method(opts: Optional[Options]) -> MethodLU:
    method = get_option(opts, Option.MethodLU, MethodLU.Auto)
    return MethodLU.from_string(method) if isinstance(method, str) else method


@instrumented("getrf")
def getrf(A: Matrix, opts: Optional[Options] = None) -> Tuple[Matrix, Pivots, torch.Tensor]:
    """LU with partial pivoting: P A = L U (reference: src/getrf.cc).

    Returns (LU, pivots, info): LU holds unit-lower L below the diagonal
    and U on/above (LAPACK layout); pivots is the net forward row
    permutation over the padded rows; info > 0 flags an exactly singular
    U diagonal."""
    slate_assert(A.op == Op.NoTrans, "getrf expects a non-transposed view")
    if _method(opts) in (MethodLU.CALU, MethodLU.BEAM):
        raise NotImplementedError(
            "getrf: tournament pivoting (MethodLU.CALU / BEAM) is not ported yet "
            "(ROADMAP.md, Queue 1 item 5); use MethodLU.PartialPiv")
    lay = A.layout
    Gp = _padded_global(A)
    sched, nb_switch, lookahead = resolve_schedule_opts(opts)
    mp, np_ = Gp.shape
    if metrics.is_on():
        route = lu_kernels.resolve_lu_schedule(mp, np_, Gp.dtype, sched, Gp.device)
        metrics.record_factor_flops("getrf", lu_kernels.getrf_schedule_flops(
            mp, np_, lay.nb, route, nb_switch, lookahead, m_true=lay.m, n_true=lay.n))
    lu2d, perm = lu_kernels.lu_global(Gp, lay.nb, sched, nb_switch, lookahead)
    LU = A._with(data=tiles_from_global(lu2d[: lay.m, : lay.n], lay))
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


@instrumented("getrs")
def getrs(LU: Matrix, pivots: Optional[Pivots], B: Matrix,
          opts: Optional[Options] = None) -> Matrix:
    """Solve A X = B from getrf factors (reference: src/getrs.cc: rows
    permuted forward, then the unit-lower and the upper solve)."""
    G = LU.to_global()
    B2 = B.to_global()
    if pivots is not None:
        B2 = torch.nn.functional.pad(B2, (0, 0, 0, pivots.perm.shape[0] - B2.shape[0]))
        B2 = pivots.apply(B2)[: B.m]
    Y = torch.linalg.solve_triangular(G, B2, upper=False, unitriangular=True)
    X = torch.linalg.solve_triangular(G, Y, upper=True)
    return B._with(data=tiles_from_global(X.to(B.dtype), B.layout))


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


def gerbt(A: Matrix, depth: int = 2, seed: int = 42, opts: Optional[Options] = None):
    """Two-sided random butterfly transform A' = U^T A V (reference:
    src/gerbt.cc); returns (A', diags_U, diags_V)."""
    Gp, du, dv, _ = _gerbt_full(A, depth, seed)
    out = Matrix.from_global(Gp[: A.n, : A.n], A.layout.mb, A.layout.nb, grid=A.grid)
    return out, du, dv


@instrumented("gesv_rbt")
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
