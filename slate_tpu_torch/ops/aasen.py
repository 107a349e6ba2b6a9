"""Aasen's LTL^H factorization with partial pivoting (host algorithm),
a copy of the JAX package's ``ops/aasen.py``.

The reference's hetrf is the two-stage Aasen method (reference:
src/hetrf.cc — panel factor + band reduction with partial pivoting in
the panel sub-communicator; hetrs.cc solves through the L/T factors).
This module provides the pivoted-stability algorithm: P A P^H = L T L^H
with L unit lower triangular (first column e_0), T Hermitian
TRIDIAGONAL, and rows pivoted by |column residual| — Aasen's 1971
recurrences, evaluated column-at-a-time with the O(n^2)-per-column work
in BLAS-2 calls.

It runs on the host in numpy, as in the JAX package and the reference:
this is the reference's design, not a fallback of the port.  The driver
(drivers/indefinite.py) moves A to the host and puts the factors back on
A's device; the same numpy input gives bitwise-equal L, alpha, beta and
perm in both packages.  The driver's pivot-free LDL^H with breakdown
detection is the device path; hetrf refactors here when it breaks down.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def aasen_ltl(A: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray, int]:
    """Factor P A P^H = L T L^H (A Hermitian, lower data referenced).

    Returns (L, alpha, beta, perm, info): L unit lower with L[:, 0] =
    e_0; T = tridiag(conj(beta), alpha, beta) with real alpha; perm the
    pivot row order (A[perm][:, perm] = L T L^H); info = 0 (the
    factorization cannot break down — a zero pivot just decouples)."""
    A = np.array(A)  # working copy, both triangles used
    A = np.tril(A) + np.tril(A, -1).conj().T
    n = A.shape[0]
    dt = A.dtype
    cplx = np.iscomplexobj(A)
    L = np.eye(n, dtype=dt)
    alpha = np.zeros(n, dtype=np.float64)
    beta = np.zeros(max(n - 1, 0), dtype=dt)
    perm = np.arange(n)

    def swap(i, j, ncols):
        """Exchange rows/cols i, j of A and rows i, j of L's COMPUTED
        columns (:ncols) — the identity tail of L must stay put."""
        if i == j:
            return
        A[[i, j], :] = A[[j, i], :]
        A[:, [i, j]] = A[:, [j, i]]
        L[[i, j], :ncols] = L[[j, i], :ncols]
        perm[[i, j]] = perm[[j, i]]

    if n == 0:
        return L, alpha, beta, perm, 0
    alpha[0] = A[0, 0].real
    if n == 1:
        return L, alpha, beta, perm, 0

    # column 0: A[1:, 0] = beta_0 * L[1:, 1]
    v = A[1:, 0].copy()
    r = int(np.argmax(np.abs(v)))
    swap(1, 1 + r, 1)
    v = A[1:, 0].copy()
    beta[0] = v[0]
    if v[0] != 0:
        L[2:, 1] = v[1:] / v[0]

    for j in range(1, n):
        lj = np.conj(L[j, : j + 1])  # row j of L, conjugated
        # h[k] = (T L^H)[k, j] for k < j: the three T terms per row
        h = np.zeros(j, dtype=dt)
        ks = np.arange(j)
        h += alpha[ks].astype(dt) * lj[ks]
        if j >= 1:
            h[1:] += beta[: j - 1] * lj[: j - 1]  # T[k, k-1] l[k-1]
            h[: j] += np.conj(beta[:j]) * lj[1 : j + 1]  # T[k, k+1] l[k+1]
        w = A[j:, j] - L[j:, :j] @ h
        # w[0] = alpha_j + beta_{j-1} conj(L[j, j-1])
        alpha[j] = (w[0] - beta[j - 1] * lj[j - 1]).real
        if j + 1 < n:
            # u = L[j+1:, j+1] beta_j
            u = w[1:] - L[j + 1 :, j] * w[0]
            r = int(np.argmax(np.abs(u)))
            if r != 0:
                swap(j + 1, j + 1 + r, j + 1)
                u[[0, r]] = u[[r, 0]]
            beta[j] = u[0]
            if u[0] != 0:
                L[j + 2 :, j + 1] = u[1:] / u[0]
            else:
                L[j + 2 :, j + 1] = 0.0
    return L, alpha, beta, perm, 0


def tridiag_solve_piv(alpha: np.ndarray, beta: np.ndarray,
                      B: np.ndarray) -> np.ndarray:
    """Solve T X = B for Hermitian tridiagonal T = tridiag(conj(beta),
    alpha, beta) with partial pivoting (dgtsv-style; fill-in limited to
    a second superdiagonal)."""
    n = alpha.shape[0]
    B = np.array(B, dtype=np.result_type(alpha, beta, B))
    # beta is the SUBdiagonal (T[k+1, k], aasen_ltl's convention); the
    # Hermitian superdiagonal is its conjugate
    dl = beta.astype(B.dtype).copy() if n > 1 else np.zeros(0, B.dtype)
    d = alpha.astype(B.dtype).copy()
    du = np.conj(beta).astype(B.dtype) if n > 1 else np.zeros(0, B.dtype)
    du2 = np.zeros(max(n - 2, 0), B.dtype)
    for k in range(n - 1):
        if abs(dl[k]) > abs(d[k]):
            # swap rows k, k+1
            d[k], dl[k] = dl[k], d[k]
            du_k = du[k]
            du[k] = d[k + 1]
            d[k + 1] = du_k
            if k + 1 < n - 1:
                du2[k] = du[k + 1]
                du[k + 1] = 0.0
            B[[k, k + 1]] = B[[k + 1, k]]
        piv = d[k] if d[k] != 0 else np.finfo(np.float64).tiny
        m = dl[k] / piv
        d[k + 1] = d[k + 1] - m * du[k]
        if k + 1 < n - 1:
            du[k + 1] = du[k + 1] - m * du2[k]
        B[k + 1] = B[k + 1] - m * B[k]
    # back substitution with two superdiagonals
    X = np.zeros_like(B)
    for k in range(n - 1, -1, -1):
        acc = B[k].copy()
        if k + 1 < n:
            acc -= du[k] * X[k + 1]
        if k + 2 < n:
            acc -= du2[k] * X[k + 2]
        piv = d[k] if d[k] != 0 else np.finfo(np.float64).tiny
        X[k] = acc / piv
    return X


def aasen_solve(L: np.ndarray, alpha: np.ndarray, beta: np.ndarray,
                perm: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Solve A X = B from the Aasen factors of P A P^H."""
    Bp = B[perm]
    Y = _unit_lower_solve(L, Bp)
    Z = tridiag_solve_piv(alpha, beta, Y)
    W = _unit_lower_solve_h(L, Z)
    X = np.zeros_like(W)
    X[perm] = W
    return X


def _unit_lower_solve(L, B):
    n = L.shape[0]
    X = np.array(B, dtype=np.result_type(L, B))
    for k in range(n):
        X[k] -= L[k, :k] @ X[:k]
    return X


def _unit_lower_solve_h(L, B):
    """Solve L^H X = B."""
    n = L.shape[0]
    X = np.array(B, dtype=np.result_type(L, B))
    Lh = np.conj(L).T
    for k in range(n - 1, -1, -1):
        X[k] -= Lh[k, k + 1 :] @ X[k + 1 :]
    return X
