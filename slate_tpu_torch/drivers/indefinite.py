"""Hermitian-indefinite solvers (reference: src/hetrf.cc Aasen two-stage
LTL^H to band, hetrs.cc, hesv.cc), the counterpart of the JAX package's
``drivers/indefinite.py``.

hetrf computes a blocked LDL^H without pivoting (``getrf_nopiv``: on a
CUDA device at n >= 2048 its panels run the Hopper ``panel_lu`` kernel
without pivot search).  When that breaks down (a zero, non-finite or
collapsed D entry, or element growth in L — e.g. a singular leading
minor of a genuinely indefinite matrix), ``method="auto"`` refactors
with Aasen's partially pivoted LTL^H (ops/aasen.py: on the host, as in
the JAX package and the reference) and ``method="rbt"`` after a
two-sided full-depth random butterfly congruence A' = U^H A U (the
Hopper ``butterfly_level`` kernel a level).  The refactor rides on the
returned factor (``L._aasen``, ``L._rbt``) and hetrs applies it;
iterative refinement in hesv restores accuracy either way.

The lazy-info contract of the JAX package holds: ``info`` is returned,
never raised inside the drivers.  The one host read is the eager
``int(info)`` that picks the breakdown refactor.  The port has no trace,
so the JAX package's traced branch (the no-pivot factor returned with a
lazy info array inside jit) has no counterpart here, nor do its tests of
that branch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..aux.metrics import instrumented
from ..enums import Op, Side, Uplo
from ..exceptions import slate_assert
from ..internal.precision import hdot
from ..matgen.philox import random_torch
from ..matrix.base import conj_transpose, single_device
from ..matrix.matrix import HermitianMatrix, Matrix, TriangularMatrix
from ..ops.aasen import aasen_ltl, aasen_solve
from ..options import Options
from ..parallel.layout import tiles_from_global
from . import blas3
from . import lu as lu_mod
from .lu import _apply_butterfly, _butterfly_diags


# Breakdown thresholds for the pivot-free pass.  Partial pivoting keeps
# |L| <= 1; without pivoting a near-singular leading minor shows up as
# element growth in L or a collapsed D entry.  Either trips the
# refactor — exact zeros alone would let a 1e-12 minor slip through to
# IR with catastrophic growth (reference: src/hetrf.cc, Aasen's
# stability rationale).
_GROWTH_LIMIT = 1e6
_DRATIO_LIMIT = 1e-12


def _ldl_nopiv(Af: torch.Tensor, mb: int, grid, opts):
    """No-pivot LDL^H of a full Hermitian 2D tensor via getrf_nopiv."""
    LU, info = lu_mod.getrf_nopiv(Matrix.from_global(Af, mb, grid=grid), opts)
    G = LU.to_global()
    # A = L U with U = D L^H for Hermitian A  =>  D = diag(U)
    d = torch.diagonal(G).real
    Ltri = torch.tril(G, -1)
    L = TriangularMatrix.from_global(Ltri + torch.eye(G.shape[0], dtype=G.dtype,
                                                      device=G.device),
                                     mb, mb, grid=grid, uplo=Uplo.Lower)
    growth = Ltri.abs().max()
    dmax, dmin = d.abs().max(), d.abs().min()
    bad = (((d == 0) | ~torch.isfinite(d)).any() | ~torch.isfinite(growth)
           | (growth > _GROWTH_LIMIT) | (dmin < _DRATIO_LIMIT * dmax))
    return L, d, torch.maximum(info, torch.where(bad, 1, 0).to(info.dtype)).to(torch.int32)


@instrumented("hetrf")
@single_device("8b2")
def hetrf(A: HermitianMatrix, opts: Optional[Options] = None, method: str = "auto"
          ) -> Tuple[TriangularMatrix, torch.Tensor, torch.Tensor]:
    """Factor A = L D L^H, L unit lower, D real diagonal (reference
    contract: src/hetrf.cc; see the module docstring for the pivot-free
    algorithm).

    Returns (L, d, info).  ``method``:

    * "auto"  — pivot-free LDL^H; on breakdown, refactor with Aasen's
      partially pivoted LTL^H (ops/aasen.py, on the host); L carries the
      Aasen factors (L._aasen) and hetrs consumes them.
    * "aasen" — Aasen directly (the reference's method).
    * "rbt"   — pivot-free with the random-butterfly breakdown fallback
      (L._rbt)."""
    slate_assert(A.m == A.n, "hetrf requires square")
    Af = A.full_global()
    lay = A.layout

    def _aasen_factor():
        Lnp, al, _be, perm, _info = aasen_ltl(Af.resolve_conj().cpu().numpy())
        L = TriangularMatrix.from_global(torch.from_numpy(Lnp), lay.mb, lay.mb,
                                         grid=A.grid, uplo=Uplo.Lower)
        L._aasen = (al, _be, perm)
        zero = torch.zeros((), dtype=torch.int32, device=L.device)
        return L, torch.from_numpy(al).to(L.device), zero

    if method == "aasen":
        return _aasen_factor()
    L, d, info = _ldl_nopiv(Af, lay.mb, A.grid, opts)
    if int(info) == 0:
        return L, d, info
    if method == "auto":
        # breakdown: the reference's pivoted-stability algorithm
        return _aasen_factor()
    # breakdown: randomize with a Hermitian-preserving butterfly congruence
    # A' = U^H A U, padded to a power of 2 with an identity block so the
    # butterfly stays invertible (gesv_rbt structure).
    n = A.n
    n2 = 1 << math.ceil(math.log2(max(n, 1)))
    # Full depth, always: depth 2 (gesv_rbt's default) mixes only at
    # coarse strides and leaves fine-grained singular-minor structure
    # (e.g. kron(I, [[0,1],[1,0]])) intact; log2(n) levels mix every
    # pair.  Deliberately not Option.Depth, which tunes gesv_rbt.
    depth = max(int(math.log2(n2)), 1)
    Ap = torch.nn.functional.pad(Af, (0, n2 - n, 0, n2 - n))
    Ap.diagonal()[n:] += 1
    du = _butterfly_diags(n2, depth, 1729, torch.float64, Af.device)
    if A.is_complex:
        # complex phases: a real congruence cannot break the structure of
        # purely imaginary Hermitian matrices (i K keeps a zero diagonal
        # under any real U^T A U)
        idx = torch.arange(depth * n2, dtype=torch.int64, device=Af.device).reshape(depth, n2)
        ph = random_torch("uniform_signed", 4242, idx, torch.zeros_like(idx), torch.float64)
        du = du * torch.exp(1j * math.pi * ph)
    du = du.to(Af.dtype)
    Ar = _apply_butterfly(Ap, du.conj().resolve_conj(), transpose=True)  # U^H A
    Ar = _apply_butterfly(Ar.T, du, transpose=True).T  # (U^H A) U
    Lr, dr, info_r = _ldl_nopiv(Ar, min(lay.mb, n2), A.grid, opts)
    Lr._rbt = (du, n)
    return Lr, dr, info_r


def _divide_d(Y: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return Y / torch.where(d == 0, torch.ones_like(d), d)[:, None].to(Y.dtype)


@instrumented("hetrs")
@single_device("8b2")
def hetrs(L: TriangularMatrix, d: torch.Tensor, B: Matrix,
          opts: Optional[Options] = None) -> Matrix:
    """Solve A X = B from the L D L^H factor (reference: src/hetrs.cc).

    Handles the plain factor, the Aasen LTL^H factor (L._aasen, solved on
    the host), and the butterfly-randomized fallback (L._rbt set by
    hetrf): A x = b <=> (U^H A U) y = U^H b, x = U y."""
    aasen_fac = getattr(L, "_aasen", None)
    if aasen_fac is not None:
        al, be, perm = aasen_fac
        Lnp = L._with(op=Op.NoTrans).to_global().resolve_conj().cpu().numpy()
        X = aasen_solve(np.tril(Lnp), al, be, perm,
                        B.to_global().resolve_conj().cpu().numpy())
        Xt = torch.from_numpy(X).to(device=B.device, dtype=B.dtype)
        return B._with(data=tiles_from_global(Xt, B.layout))

    rbt = getattr(L, "_rbt", None)
    if rbt is None:
        Y = blas3.trsm(Side.Left, 1.0, L, B, opts)
        Yg = _divide_d(Y.to_global(), d)
        Ym = B._with(data=tiles_from_global(Yg.to(B.dtype), B.layout))
        return blas3.trsm(Side.Left, 1.0, conj_transpose(L), Ym, opts)

    du, n = rbt
    n2 = L.n
    Bp = torch.nn.functional.pad(B.to_global(), (0, 0, 0, n2 - n))
    Rp = _apply_butterfly(Bp, du.conj().resolve_conj(), transpose=True)  # U^H b
    Lg = L._with(op=Op.NoTrans).to_global()
    Y = torch.linalg.solve_triangular(Lg, Rp, upper=False, unitriangular=True)
    Z = torch.linalg.solve_triangular(Lg.mH, _divide_d(Y, d), upper=True)
    X = _apply_butterfly(Z, du, transpose=False)[:n]
    return B._with(data=tiles_from_global(X.to(B.dtype), B.layout))


@instrumented("hesv")
@single_device("8b2")
def hesv(A: HermitianMatrix, B: Matrix, opts: Optional[Options] = None
         ) -> Tuple[Matrix, TriangularMatrix, torch.Tensor, torch.Tensor]:
    """Hermitian-indefinite solve (reference: src/hesv.cc = hetrf +
    hetrs) with two sweeps of iterative refinement of the solution."""
    L, d, info = hetrf(A, opts)
    X = hetrs(L, d, B, opts)
    Af, B2 = A.full_global(), B.to_global()
    for _ in range(2):
        R = B2 - hdot(Af, X.to_global())
        C = hetrs(L, d, B._with(data=tiles_from_global(R.to(B.dtype), B.layout)), opts)
        X = X._with(data=X.data + C.data)
    return X, L, d, info
