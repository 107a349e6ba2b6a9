"""Parallel-order Jacobi polishing for eigen/SVD accuracy, the
counterpart of the JAX package's ``ops/jacobi.py``.

These kernels polish an approximate decomposition to full working
precision with round-robin parallel-order Jacobi sweeps: each round
rotates n/2 disjoint index pairs at once, so one round is two row/column
pair updates over the whole matrix.  Near-diagonal input converges in
1-3 sweeps.  The JAX package's ``lax.while_loop`` over the sweeps is a
Python loop here that reads the off-diagonal norm from the device once a
sweep.

``eigh_accurate`` / ``svd_accurate`` polish the library result on a
CUDA device, as the JAX package polishes off the CPU; on the CPU they
return the library result.  ``svd_accurate`` solves the SVD's gathered
band where the Jordan-Wielandt chase does not apply (drivers/svd.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..internal.precision import hdot


def _round_robin(n: int) -> np.ndarray:
    """(n-1, n//2, 2) round-robin pairing schedule (n even): every round
    is a perfect matching; over n-1 rounds every pair meets."""
    assert n % 2 == 0
    arr = list(range(1, n))
    rounds = []
    for _ in range(n - 1):
        cur = [0] + arr
        rounds.append([(min(cur[i], cur[n - 1 - i]), max(cur[i], cur[n - 1 - i]))
                       for i in range(n // 2)])
        arr = arr[-1:] + arr[:-1]
    return np.asarray(rounds, dtype=np.int64)


def _rotation(app, aqq, apq):
    """Jacobi rotation (c, s, u) zeroing the (p, q) coupling of the 2x2
    [[app, apq], [conj(apq), aqq]]: G = [[c, s u], [-s conj(u), c]].
    Large tau takes the asymptotic branch t = 1/(2 tau); couplings below
    eps (|app| + |aqq|) / 4 are skipped (their angle is under eps)."""
    absa = apq.abs()
    eps = torch.finfo(absa.dtype).eps
    app_r, aqq_r = app.real, aqq.real
    skip = (absa == 0) | (absa <= 0.25 * eps * (app_r.abs() + aqq_r.abs()))
    safe = torch.where(skip, 1.0, absa)
    u = torch.where(skip, torch.ones_like(apq), apq / safe)
    tau = (aqq_r - app_r) / (2 * safe)
    big = tau.abs() > 1e8
    tau_s = torch.where(big, 1.0, tau)
    t_small = torch.sign(tau_s) / (tau_s.abs() + torch.sqrt(1 + tau_s * tau_s))
    t_big = 1.0 / (2.0 * torch.where(big, tau, 1.0))
    t = torch.where(big, t_big, t_small)
    t = torch.where(tau == 0, 1.0, t)
    c = 1.0 / torch.sqrt(1 + t * t)
    s = t * c
    return torch.where(skip, 1.0, c), torch.where(skip, 0.0, s), u


def _offdiag_norm(M):
    return torch.linalg.norm(M - torch.diag(torch.diagonal(M)))


def _rotate_cols(X, p, q, cu, s_cu, su_r):
    """X[:, p], X[:, q] <- cu X_p - s conj(u) X_q, su X_p + cu X_q."""
    Xp, Xq = X[:, p], X[:, q]
    X[:, p] = cu * Xp - s_cu * Xq
    X[:, q] = su_r * Xp + cu * Xq


def _pad_one(X, corner):
    X = F.pad(X, (0, 1, 0, 1))
    X[-1, -1] = corner
    return X


def jacobi_eigh_polish(A: torch.Tensor, V0: torch.Tensor, max_sweeps: int = 12,
                       want_vectors: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polish an approximate eigenbasis V0 of Hermitian A to working
    precision.  Returns (w ascending, V with matching columns).

    M = V0^H A V0 is near-diagonal; parallel-order Jacobi sweeps drive
    its off-diagonal below n eps ||A|| while accumulating the rotations
    into V."""
    n = A.shape[0]
    complex_t = A.is_complex()
    npad = n + (n % 2)
    sched = torch.as_tensor(_round_robin(npad), device=A.device)
    M = hdot(hdot(V0.mH, A), V0)
    M = 0.5 * (M + M.mH)
    V = V0.clone()
    if npad != n:
        M = _pad_one(M, 2.0 * torch.diagonal(M).abs().max() + 1.0)
        V = _pad_one(V, 1.0)
    tol = torch.finfo(M.real.dtype).eps * torch.linalg.norm(M) * npad
    conj = (lambda x: x.conj()) if complex_t else (lambda x: x)
    for _ in range(max_sweeps):
        if not bool(_offdiag_norm(M) > tol):
            break
        for r in range(npad - 1):
            p, q = sched[r, :, 0], sched[r, :, 1]
            c, s, u = _rotation(M[p, p], M[q, q], M[p, q])
            cu = c.to(M.dtype)
            su_r = s * u if complex_t else s * u.real
            s_cu = s * conj(u)
            _rotate_cols(M, p, q, cu, s_cu, su_r)
            if want_vectors:
                _rotate_cols(V, p, q, cu, s_cu, su_r)
            # rows: G^H M
            Rp, Rq = M[p, :], M[q, :]
            M[p, :] = cu[:, None] * Rp - su_r[:, None] * Rq
            M[q, :] = s_cu[:, None] * Rp + cu[:, None] * Rq
    w = torch.diagonal(M).real[:n]
    order = torch.argsort(w, stable=True)
    return w[order], V[:n, :n][:, order]


def jacobi_svd_polish(A: torch.Tensor, V0: torch.Tensor, max_sweeps: int = 12):
    """Polish an approximate right singular basis V0 of square A by
    one-sided Jacobi on B = A V0 (rotate column pairs of B and V until
    mutually orthogonal; then s = ||b_j||).  Returns (U, s descending,
    V)."""
    n = A.shape[0]
    complex_t = A.is_complex()
    npad = n + (n % 2)
    sched = torch.as_tensor(_round_robin(npad), device=A.device)
    B = hdot(A, V0)
    V = V0.clone()
    if npad != n:
        B = _pad_one(B, 1.0)
        V = _pad_one(V, 1.0)
    fro = torch.linalg.norm(B)
    tol2 = torch.finfo(B.real.dtype).eps * fro * fro * npad  # <b_p, b_q> scale
    conj = (lambda x: x.conj()) if complex_t else (lambda x: x)

    def gram_off(B):
        return _offdiag_norm(hdot(B.mH, B))

    for _ in range(max_sweeps):
        if not bool(gram_off(B) > tol2):
            break
        for r in range(npad - 1):
            p, q = sched[r, :, 0], sched[r, :, 1]
            Bp, Bq = B[:, p], B[:, q]
            x = (Bp.abs() ** 2).sum(0)
            y = (Bq.abs() ** 2).sum(0)
            z = (Bp.conj() * Bq).sum(0)
            c, s, u = _rotation(x, y, z)
            cu = c.to(B.dtype)
            su_r = s * u if complex_t else s * u.real
            s_cu = s * conj(u)
            _rotate_cols(B, p, q, cu, s_cu, su_r)
            _rotate_cols(V, p, q, cu, s_cu, su_r)
    # U from a QR of the (orthogonal-columned) B: R is diagonal to the
    # sweep tolerance, and the QR's completion covers zero columns
    Q, Rr = torch.linalg.qr(B, mode="reduced")
    rd = torch.diagonal(Rr)
    s = rd.abs()
    phase = torch.where(s == 0, torch.ones_like(rd), rd / torch.where(s == 0, 1.0, s))
    U = Q * phase[None, :]
    s, U, V = s[:n], U[:n, :n], V[:n, :n]
    order = torch.argsort(-s, stable=True)
    return U[:, order], s[order], V[:, order]


def eigh_accurate(A: torch.Tensor, vectors: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The library eigh followed by the Jacobi polish on a CUDA device;
    the library eigh / eigvalsh alone on the CPU."""
    if not A.is_cuda:
        if vectors:
            return torch.linalg.eigh(A)
        return torch.linalg.eigvalsh(A), None
    w, V = torch.linalg.eigh(A)
    w, V = jacobi_eigh_polish(A, V, want_vectors=vectors)
    return (w, V) if vectors else (w, None)


def _upcast(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype.is_complex else torch.float64


def svd_accurate(A: torch.Tensor, compute_uv: bool = True):
    """The library SVD followed by the one-sided Jacobi polish on a CUDA
    device (the library result alone on the CPU).  Rectangular inputs
    are QR/LQ-reduced to the square core first; 32-bit inputs are solved
    in 64 bits and rounded back.  Returns (U, s, Vh) as
    ``torch.linalg.svd(full_matrices=False)``, or s alone when
    ``compute_uv`` is False."""
    low = torch.finfo(A.real.dtype).bits <= 32
    if not compute_uv:
        if not A.is_cuda or not low:
            return torch.linalg.svdvals(A)
        return torch.linalg.svdvals(A.to(_upcast(A.dtype))).to(A.real.dtype)
    if not A.is_cuda:
        return torch.linalg.svd(A, full_matrices=False)
    if low:
        U, s, Vh = svd_accurate(A.to(_upcast(A.dtype)), compute_uv=True)
        return U.to(A.dtype), s.to(A.real.dtype), Vh.to(A.dtype)
    m, n = A.shape
    if m > n:
        Q, R = torch.linalg.qr(A, mode="reduced")
        U2, s, Vh = svd_accurate(R)
        return hdot(Q, U2), s, Vh
    if m < n:
        U2, s, Vh2 = svd_accurate(A.mH)
        return Vh2.mH, s, U2.mH
    _, _, Vh = torch.linalg.svd(A, full_matrices=False)
    U2, s2, V2 = jacobi_svd_polish(A, Vh.mH)
    return U2, s2, V2.mH
