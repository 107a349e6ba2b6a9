"""Tridiagonal eigenvectors by batched inverse iteration (stein), the
counterpart of the JAX package's ``ops/stein.py``: the independent
fallback for the stedc path (reference role: src/steqr_impl.cc;
algorithmically LAPACK's dstebz + dstein pairing: eigenvalues from the
parallel Sturm bisection, vectors from shifted inverse iteration).

One tridiagonal LU with partial pivoting for all n shifts at once (a
Python loop over the rows, each step batched over the shifts: the JAX
package's ``lax.scan`` under ``vmap``), two batched solve sweeps an
iteration, then a CholQR2 orthonormalisation of the whole block, which
also handles clusters: inverse iterates mixed within a numerical cluster
still span its invariant subspace.  The start vectors are the counter-
based Philox stream of ``matgen/philox.py``, bit for bit the JAX
package's.
"""

from __future__ import annotations

import torch

from ..internal.precision import hdot as _dot
from ..matgen.philox import _bits_to_unit_torch, philox_2x64_torch

_SEED = 0x5E17


def _factor_shifted(d, e, lam, pivmin):
    """Partial-pivot LU of (T - lam_k I) for every shift lam_k: returns
    (u1, u2, u3, m, swap), each (K, n): U's three stored diagonals, the
    multipliers and the swap flags (LAPACK dgttrf's recurrence).
    ``pivmin`` replaces a zero pivot."""
    n = d.shape[0]
    K = lam.shape[0]
    dt, dev = d.dtype, d.device
    ep = torch.cat([e, torch.zeros(1, dtype=dt, device=dev)])
    d0 = d[None, :] - lam[:, None]
    p1, p2, p3 = d0[:, 0], ep[0].expand(K), torch.zeros(K, dtype=dt, device=dev)
    rows = []  # (piv, u2, u3, m, swap) of rows 0 .. n-2
    for k in range(n - 1):
        ek, dk1, ek1 = ep[k], d0[:, k + 1], ep[k + 1]
        swap = ek.abs() > p1.abs()
        r1, r2, r3 = torch.where(swap, ek, p1), torch.where(swap, dk1, p2), torch.where(swap, ek1, p3)
        s1, s2, s3 = torch.where(swap, p1, ek), torch.where(swap, p2, dk1), torch.where(swap, p3, ek1)
        piv = torch.where(r1.abs() < pivmin, pivmin, r1)
        m = s1 / piv
        p1, p2, p3 = s2 - m * r2, s3 - m * r3, torch.zeros_like(p3)
        rows.append((piv, r2, r3, m, swap))
    zero = torch.zeros(K, dtype=dt, device=dev)
    rows.append((torch.where(p1.abs() < pivmin, pivmin, p1), zero, zero, zero,
                 torch.zeros(K, dtype=torch.bool, device=dev)))
    return tuple(torch.stack(x, 1) for x in zip(*rows))


def _solve_factored(u1, u2, u3, m, swap, b):
    """Solve L U x = P b given the factor streams, every row of b with
    its own shift's factors."""
    n = b.shape[1]
    y = torch.empty_like(b)
    bk = b[:, 0]
    for k in range(n - 1):  # forward: the pivoted elimination
        bk1, mk, sk = b[:, k + 1], m[:, k], swap[:, k]
        hi = torch.where(sk, bk1, bk)
        bk = torch.where(sk, bk, bk1) - mk * hi
        y[:, k] = hi
    y[:, n - 1] = bk
    x = torch.empty_like(b)
    x1 = x2 = torch.zeros_like(bk)
    for k in range(n - 1, -1, -1):  # backward: U's three diagonals
        xk = (y[:, k] - u2[:, k] * x1 - u3[:, k] * x2) / u1[:, k]
        x[:, k] = xk
        x1, x2 = xk, x1
    return x


def start_vectors(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """(n, n) start vectors in [-0.5, 0.5): Philox 2x64 of (i, j) with
    the seed 0x5E17 (structured starts can be orthogonal to whole
    eigenvector families, e.g. the Toeplitz sine basis)."""
    ii = torch.arange(n, device=device)[:, None].expand(n, n).reshape(-1)
    jj = torch.arange(n, device=device)[None, :].expand(n, n).reshape(-1)
    Lbits, _ = philox_2x64_torch(ii, jj, _SEED)
    return _bits_to_unit_torch(Lbits, dtype).reshape(n, n) - 0.5


def stein(d: torch.Tensor, e: torch.Tensor, w: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Eigenvectors of tridiag(d, e) for the eigenvalues w by batched
    inverse iteration and a CholQR2 orthonormalisation.  Returns Z
    (n, n) with T Z ~= Z diag(w)."""
    n = d.shape[0]
    dt, dev = d.dtype, d.device
    if n == 1:
        return torch.ones((1, 1), dtype=dt, device=dev)
    eps = torch.finfo(dt).eps
    # separate equal shifts a hair so iterates within an exact cluster
    # are not identical columns
    scale = torch.maximum(d.abs().max(), e.abs().max())
    scale = torch.where(scale > 0, scale, 1.0)
    lam = w + (torch.arange(n, dtype=dt, device=dev) - 0.5 * n) * (4.0 * eps * scale)
    factors = _factor_shifted(d, e, lam, scale * 1e-30)
    V = start_vectors(n, dt, dev)  # rows indexed by shift
    for _ in range(iters):
        V = _solve_factored(*factors, V)
        # max-scale first: a dead-on shift amplifies by ~1/pivmin and the
        # squared norm would overflow
        mx = V.abs().amax(1, keepdim=True)
        V = V / torch.where(mx == 0, 1.0, mx)
        nrm = torch.sqrt((V * V).sum(1, keepdim=True))
        V = V / torch.where(nrm == 0, 1.0, nrm)
    Z = V.T
    eye = torch.eye(n, dtype=dt, device=dev)
    for _ in range(2):  # CholQR2: orthonormalise, keeping cluster spans
        G = _dot(Z.T, Z)
        G = G + eps * 4 * torch.trace(G) / n * eye
        L = torch.linalg.cholesky(G)
        Z = torch.linalg.solve_triangular(L.mT, Z, upper=True, left=False)
    return Z
