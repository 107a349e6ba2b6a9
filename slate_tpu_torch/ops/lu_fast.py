"""Three-level blocked LU with partial pivoting (reference: src/getrf.cc:
85-214), the counterpart of the JAX package's ``ops/lu_fast.py``: the
``flat_fast`` route that an explicit ``Schedule.Flat`` takes for square
n >= 2048 divisible by 128.  Plain tensor code, no kernel of its own.

* micro level (``_lu_panel_strips``): ib-wide column strips of an
  (m, w) panel.  No row moves during the elimination: an eligibility
  mask tracks the pivoted rows, each column is a rank-1 update of its
  strip only, each strip one rank-ib update of the rest of the panel
  through an exact unit-lower inverse (nilpotent squaring).  One gather
  at the end puts the rows in LAPACK's swap order.
* sub-panel level (``_block_lu``): the nb-wide panels of an (m, NB)
  coarse block, the active rows rolled to the top as in the JAX package.
* coarse level (``blocked_getrf_fast``): at most ``coarse_panels`` panels
  of width NB at exact shrinking shapes; the panel solve goes through
  an explicit unit-lower inverse.

Pivot choice is LAPACK's partial pivoting up to ties: exact-magnitude
ties go to the lowest ORIGINAL row index (LAPACK scans in swapped
order), as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..internal.precision import hdot as _dot


def _unit_lower_inv(L: torch.Tensor) -> torch.Tensor:
    """Exact inverse of a unit-lower (b, b) matrix by nilpotent squaring:
    (I + N)^-1 = (I - N)(I + N^2)(I + N^4)..."""
    b = L.shape[0]
    eye = torch.eye(b, dtype=L.dtype, device=L.device)
    N = torch.tril(L, -1)
    inv = eye - N
    P = N
    k = 2
    while k < b:
        P = _dot(P, P)
        inv = _dot(inv, eye + P)
        k *= 2
    return inv


def _lu_panel_strips(P: torch.Tensor, act: int, ib: int = 32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial-pivot LU of an (m, w) panel, w a multiple of ib; only rows
    < act are eligible pivots.  Returns (P, perm): L\\U of the w columns,
    rows in LAPACK pivot order, P's rows are the input's rows perm."""
    m, w = P.shape
    P = P.clone()
    rows = torch.arange(m, device=P.device)
    colsw = torch.arange(w, device=P.device)
    zero = torch.zeros((), dtype=P.dtype, device=P.device)
    unpiv = rows < act
    pivrows = torch.zeros(w, dtype=torch.long, device=P.device)
    for j0 in range(0, w, ib):
        S = P[:, j0:j0 + ib].clone()
        for c in range(ib):
            colc = S[:, c]
            piv = torch.argmax(torch.where(unpiv, colc.abs(), -math.inf))
            pv = colc[piv]
            safe = torch.where(pv == 0, torch.ones_like(pv), pv)
            elig = unpiv & (rows != piv) & (pv != 0)
            l = torch.where(elig, colc / safe, zero)
            S[:, c] = torch.where(unpiv & (rows != piv), l, colc)
            unpiv = unpiv.clone()
            unpiv[piv] = False
            pivrows[j0 + c] = piv
            if c + 1 < ib:
                tail = S[:, c + 1:]
                S[:, c + 1:] = tail - torch.outer(l, tail[piv])
        P[:, j0:j0 + ib] = S
        # rank-ib update of the rest of the panel through the strip's
        # pivot rows and an exact unit-lower inverse
        stripiv = pivrows[j0:j0 + ib]
        Srows = P[stripiv]
        U12 = _dot(_unit_lower_inv(Srows[:, j0:j0 + ib]), Srows)
        cmask = (colsw >= j0 + ib)[None, :]
        P[stripiv] = torch.where(cmask, U12, Srows)
        L21 = torch.where(unpiv[:, None], S, zero)
        P = P - torch.where(cmask, _dot(L21, U12), zero)

    # LAPACK's row order: replay the swap sequence on an index vector
    perm = np.arange(m, dtype=np.int32)
    pos = np.arange(m, dtype=np.int64)
    for j, r in enumerate(pivrows.cpu().numpy()):
        p = pos[r]
        rj, rp = perm[j], perm[p]
        perm[j], perm[p] = rp, rj
        pos[rp], pos[rj] = j, p
    perm_t = torch.from_numpy(perm).to(P.device)
    return P[perm_t.long()], perm_t


def _block_lu(B: torch.Tensor, nb: int, ib: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial-pivot LU of an (m, W) block, m >= W, W a multiple of nb,
    panel by panel (the active rows rolled to the top).  Returns (B,
    perm): L\\U packed, perm the net forward row permutation."""
    m, W = B.shape
    rows = torch.arange(m, device=B.device)
    colsW = torch.arange(W, device=B.device)
    zero = torch.zeros((), dtype=B.dtype, device=B.device)
    eye_nb = torch.eye(nb, dtype=B.dtype, device=B.device)
    perm = torch.arange(m, dtype=torch.int32, device=B.device)
    for j0 in range(0, W, nb):
        rolled = torch.roll(B[:, j0:j0 + nb], -j0, dims=0)
        act = m - j0
        rolled = torch.where((rows < act)[:, None], rolled, zero)
        Pf, perm_loc = _lu_panel_strips(rolled, act, ib)
        mapped = torch.where(rows >= j0, perm_loc.long()[(rows - j0).clamp(0, m - 1)] + j0,
                             rows)
        B, perm = B[mapped], perm[mapped]
        neu = torch.where((rows >= j0)[:, None], torch.roll(Pf, j0, dims=0), B[:, j0:j0 + nb])
        B[:, j0:j0 + nb] = neu
        Lnb = torch.tril(Pf[:nb], -1) + eye_nb
        Linv = torch.linalg.solve_triangular(Lnb, eye_nb, upper=False, unitriangular=True)
        Rtop = B[j0:j0 + nb]
        U12 = _dot(Linv, Rtop)
        cmask = (colsW >= j0 + nb)[None, :]
        B[j0:j0 + nb] = torch.where(cmask, U12, Rtop)
        L21 = torch.where((rows >= j0 + nb)[:, None], neu, zero)
        B = B - _dot(L21, torch.where(cmask, U12, zero))
    return B, perm


def blocked_getrf_fast(G: torch.Tensor, nb: int = 512, ib: int = 32,
                       coarse_panels: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked right-looking LU with partial pivoting of a square padded
    tensor (n a multiple of nb).  Returns (LU, perm): LU = (L\\U) of
    G[perm], the contract of ``lu_kernels.blocked_getrf``."""
    n = G.shape[0]
    if n % nb != 0:
        raise ValueError(f"blocked_getrf_fast: n={n} not a multiple of nb={nb}")
    nt = n // nb
    if nt <= 1:
        return _lu_panel_strips(G, n, ib)
    perm = torch.arange(n, dtype=torch.int32, device=G.device)
    NB = nb * (-(-nt // coarse_panels))
    G = G.clone()
    k0 = 0
    while k0 < n:
        W = min(NB, n - k0)
        Bf, permB = _block_lu(G[k0:, k0:k0 + W], nb, ib)
        step = torch.cat([torch.arange(k0, device=G.device), permB.long() + k0])
        G, perm = G[step], perm[step]
        G[k0:, k0:k0 + W] = Bf
        rest = n - k0 - W
        if rest > 0:
            eye = torch.eye(W, dtype=G.dtype, device=G.device)
            LW = torch.tril(Bf[:W], -1) + eye
            Linv = torch.linalg.solve_triangular(LW, eye, upper=False, unitriangular=True)
            U12 = _dot(Linv, G[k0:k0 + W, k0 + W:])
            G[k0:k0 + W, k0 + W:] = U12
            G[k0 + W:, k0 + W:] -= _dot(Bf[W:, :W], U12)
        k0 += W
    return G, perm
