"""Restarted GMRES-IR core, the port of the JAX package's
``refine/gmres.py`` (reference: src/gesv_mixed_gmres.cc:110-165 —
right-preconditioned GMRES per column, restart 30, residual acceptance
test; Carson & Higham SISC 2018 §4 for why preconditioned GMRES
survives ~1/eps_factor more ill-conditioning than classical IR: the
Krylov solve only needs the preconditioned operator U^-1 L^-1 A ~ I + E
to be *solvable*, not the stationary iteration matrix E to be
contractive).

Shape: an outer refinement loop (a Python ``while``, one host read a
step, like ``ir.refine_while``) whose correction step is one
GMRES(restart) cycle for every RHS column at once, preconditioned by the
low-precision factors *applied in working precision* (the mixed solvers upcast
them once): a preconditioner applied at eps_factor perturbs the Krylov
operator enough to stall GMRES at berr ~ eps_factor.  The JAX package
runs the cycle once a column under ``vmap``; here the columns are a
batch axis of the Krylov basis, so one preconditioner application and
one product with A serve all of them.  The outer loop stops on the same
componentwise backward-error test as classical IR.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..internal.precision import hdot
from .ir import backward_error, residual_berr


class GmresResult(NamedTuple):
    X: torch.Tensor
    cycles: int  # GMRES(restart) cycles taken
    converged: bool
    berr: torch.Tensor


def lstsq_min_norm(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least-squares solutions of a batch of small systems,
    ``jnp.linalg.lstsq``'s: an SVD of each (M, N) block ``H[c]`` with
    singular values kept where ``s > 0`` and ``s >= eps max(M, N) s[0]``.
    An all-zero block (a zero residual column) gives x = 0, a singular
    one (a happy breakdown) the minimum-norm solution, a block or right
    side with a non-finite value a NaN solution (the library SVD would
    raise there).  H (C, M, N), b (C, M); returns (C, N)."""
    M, N = H.shape[-2:]
    bad = ~(torch.isfinite(H).all(dim=(1, 2)) & torch.isfinite(b).all(dim=1))
    U, s, Vh = torch.linalg.svd(torch.where(bad[:, None, None], 0, H), full_matrices=False)
    rcond = torch.finfo(H.dtype).eps * max(M, N)
    mask = (s > 0) & (s >= rcond * s[:, :1])
    s_inv = torch.where(mask, 1 / torch.where(mask, s, 1), 0).to(H.dtype)
    uTb = (U.mH @ b[:, :, None])[:, :, 0]
    x = (Vh.mH @ (s_inv * uTb)[:, :, None])[:, :, 0]
    return torch.where(bad[:, None], float("nan"), x)


def _gmres_cycle(A2: torch.Tensor, precond: Callable, R: torch.Tensor,
                 restart: int) -> torch.Tensor:
    """One right-preconditioned GMRES(restart) cycle for every column of
    R (n, nrhs) at once: returns the corrections D ~ A^-1 R (a zero
    column where R's is zero).  V is (restart+1, n, nrhs), H is
    (restart+1, restart, nrhs); modified Gram-Schmidt runs over the
    basis in Python, each step a batch over the columns."""
    n, nrhs = R.shape
    beta = torch.linalg.vector_norm(R, dim=0)  # (nrhs,)
    V = torch.zeros((restart + 1, n, nrhs), dtype=R.dtype, device=R.device)
    H = torch.zeros((restart + 1, restart, nrhs), dtype=R.dtype, device=R.device)
    V[0] = R / torch.where(beta == 0, 1, beta)
    for j in range(restart):
        w = hdot(A2, precond(V[j]))
        for i in range(j + 1):  # modified Gram-Schmidt
            hij = (V[i].conj() * w).sum(dim=0)
            H[i, j] = hij
            w = w - hij * V[i]
        hn = torch.linalg.vector_norm(w, dim=0)
        H[j + 1, j] = hn.to(H.dtype)
        V[j + 1] = w / torch.where(hn == 0, 1, hn)
    e1 = torch.zeros((nrhs, restart + 1), dtype=R.dtype, device=R.device)
    e1[:, 0] = beta.to(R.dtype)
    y = lstsq_min_norm(H.permute(2, 0, 1), e1)  # (nrhs, restart)
    return precond(torch.einsum("knc,ck->nc", V[:restart], y))


def gmres_refine(
    A2: torch.Tensor,
    B2: torch.Tensor,
    precond: Callable[[torch.Tensor], torch.Tensor],
    tol: float,
    restart: int = 30,
    max_cycles: int = 4,
) -> GmresResult:
    """Restarted GMRES-IR: start from X = precond(B), then per cycle
    correct every column with one GMRES(restart) solve of A d = r until
    the componentwise backward error passes ``tol`` or ``max_cycles``
    cycles are spent.  The caller owns the fallback decision on
    ``converged == False``."""
    X = precond(B2)
    cycles, converged = 0, False
    berr = torch.full((), float("inf"), dtype=B2.abs().dtype, device=B2.device)
    while not converged and cycles < max_cycles:
        R, berr = residual_berr(A2, X, B2)  # the shared stopping test
        converged = bool(berr <= tol)
        if not converged:  # a converged check pays no dead cycle
            X = X + _gmres_cycle(A2, precond, R, restart)
            cycles += 1
    # recheck only the budget-exhausted exit (see ir.refine_while)
    final_berr = berr if converged else backward_error(A2, X, B2)
    return GmresResult(X=X, cycles=cycles,
                       converged=converged or bool(final_berr <= tol), berr=final_berr)
