"""Windowed band factorization and solve kernels: O(n kd^2) work instead
of O(n^3) (reference: src/pbtrf.cc, gbtrf.cc, tbsm.cc, which restrict
their task loops to in-band tiles), the counterpart of the JAX package's
``ops/band_kernels.py``.

All kernels take the dense (n, n) global tensor of a band matrix (the
band storage of both packages) and touch only windows of O(kd + w) rows
and columns a step.  Where the JAX package runs one ``lax.fori_loop``
body over dynamic slices, each loop here is a Python loop over views of
one padded tensor, each window written back in place (``copy_`` through
the view), so a step allocates only its window's temporaries.

* ``band_potrf_lower`` — the window's diagonal Cholesky goes through the
  ``cholesky`` dispatcher (on a CUDA device below ``RECURSIVE_MIN_N`` its
  ``flat`` schedule, as the JAX package dispatches its own).
* ``band_getrf`` — the window panel goes through
  ``lu_kernels._panel_route``: the Hopper ``panel_lu`` kernel at shape
  (w + kl, w) on a CUDA float32/float64 tensor, the plain panel
  elsewhere (both bitwise equal, so pivots do not depend on the route).
* ``band_trsm_lower`` / ``band_getrs`` — library solves and products.

The upper and transposed solves reverse the index order (J U J is lower
band); torch has no negative strides, so each reversal is a
``torch.flip`` copy of the operand.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..internal.precision import hdot as _dot
from .chol_kernels import cholesky as _chol_tile
from .lu_kernels import _panel_route


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _win_size(kd: int) -> int:
    """Window step: big enough to amortize the per-step dispatch, small
    enough to keep window FLOPs ~ O(w kd^2)."""
    return int(min(max(kd, 32), 512))


def _pad_splice(G: torch.Tensor, rows: int, cols: int, n: int, offset: int = 0,
                left: int = 0) -> torch.Tensor:
    """G padded with zeros to (rows, left + cols) (``left`` zero columns
    before G), and ones added on the padding part of the diagonal of
    offset ``offset``: entries [i, i + offset] for i >= n."""
    Gp = torch.nn.functional.pad(G.resolve_conj(),
                                 (left, cols - G.shape[1], 0, rows - G.shape[0]))
    Gp.diagonal(offset)[n:] += 1
    return Gp


def band_potrf_lower(G: torch.Tensor, kd: int) -> torch.Tensor:
    """Cholesky of a Hermitian band matrix with lower bandwidth kd
    (lower triangle of G valid).  Returns the lower band factor L
    (dense (n, n), zero outside the band).

    Per window: w x w diagonal Cholesky, a kd x w triangular solve, and
    the kd x kd trailing update — the pbtrf.cc loop restricted to the
    band (reference: src/pbtrf.cc:40-108).  The window's upper triangle
    is never read and is left stale (the result is masked)."""
    n = G.shape[0]
    if kd >= n - 1:
        lower = torch.tril(torch.ones((n, n), dtype=torch.bool, device=G.device))
        return torch.tril(_chol_tile(torch.where(lower, G, G.mH), 512))
    w = _win_size(kd)
    steps = _ceil_div(n, w)
    npad = steps * w + w + kd
    Gp = _pad_splice(G, npad, npad, n)
    W = w + kd
    tri = torch.tril(torch.ones((w, w), dtype=torch.bool, device=G.device))
    for k in range(steps):
        off = k * w
        Wd = Gp[off:off + W, off:off + W]
        A11 = Wd[:w, :w]
        L11 = torch.tril(_chol_tile(torch.where(tri, A11, A11.mH), min(w, 512)))
        # X L11^H = A21
        L21 = torch.linalg.solve_triangular(L11.mH, Wd[w:, :w], upper=True, left=False)
        Wd[w:, w:] -= _dot(L21, L21.mH)
        Wd[:w, :w].copy_(L11)
        Wd[w:, :w].copy_(L21)
    # tril, then i - j <= kd: tril/triu write zeros, as the JAX where does
    return torch.triu(torch.tril(Gp[:n, :n]), -kd)


def band_trsm_lower(L: torch.Tensor, B: torch.Tensor, kd: int,
                    unit_diag: bool = False) -> torch.Tensor:
    """Solve L X = B with L lower band (bandwidth kd): forward windowed
    substitution, O(n kd nrhs) (reference: src/tbsm.cc's in-band task
    loop).  Upper/transposed solves reduce to this by the index reversal
    J U J = lower band (see drivers/band.py::tbsm); a conjugated L is
    passed conjugated (the JAX function's ``conj`` flag has no caller)."""
    n, nrhs = B.shape
    w = _win_size(kd)
    steps = _ceil_div(n, w)
    npad = steps * w
    # shifted storage: column c of L at column c + kd, so every window's
    # left dependency strip is an in-bounds slice
    Lp = _pad_splice(L, npad, npad, n, offset=kd, left=kd)
    # X rows at row r + kd (kd zero rows on top = the "no earlier X"
    # boundary for the first window)
    Xp = torch.nn.functional.pad(B.to(L.dtype), (0, 0, kd, npad - n))
    for k in range(steps):
        off = k * w
        Wd = Lp[off:off + w, off:off + kd + w]
        rhs = Xp[off + kd:off + kd + w] - _dot(Wd[:, :kd], Xp[off:off + kd])
        Xw = torch.linalg.solve_triangular(torch.tril(Wd[:, kd:]), rhs, upper=False,
                                           unitriangular=unit_diag)
        Xp[off + kd:off + kd + w].copy_(Xw)
    return Xp[kd:kd + n].to(B.dtype)


def band_getrf(G: torch.Tensor, kl: int, ku: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Pivoted LU of a band matrix (dense-stored, bandwidths kl/ku):
    windowed gbtrf (reference: src/gbtrf.cc — panel + in-band trailing
    update with pivot fill-in of kl extra superdiagonals).

    Uses LAPACK's banded-pivot convention: row swaps act only on the
    current window (the multipliers of earlier columns stay in place),
    which keeps L banded.  The solve must therefore replay the window
    swaps interleaved with the window eliminations (band_getrs).

    Returns (LU, lperms, perm, w): LU holds in-place unit-lower
    multipliers (per-column span < w + kl) and U with bandwidth
    kl + ku; lperms is (steps, w + kl) int32 window-local pivot orders;
    perm (int32) the net forward row permutation; w the window step.
    Each window touches (w + kl) x (w + kl + ku) entries:
    O(n (kl + w)(kl + ku + w)) total work."""
    n = G.shape[0]
    w = _win_size(max(kl, ku, 1))
    steps = _ceil_div(n, w)
    W1 = w + kl  # rows a panel can pivot over
    W2 = w + kl + ku  # columns those rows touch
    npad = steps * w + W1 + W2
    Gp = _pad_splice(G, npad, npad, n)
    perm = torch.arange(npad, dtype=torch.int32, device=G.device)
    lperms = torch.zeros((steps, W1), dtype=torch.int32, device=G.device)
    panel_lu = _panel_route(G.dtype, G.device)
    for k in range(steps):
        off = k * w
        Wd = Gp[off:off + W1, off:off + W2]
        lu_pan, lperm = panel_lu(Wd[:, :w])
        lp = lperm.long()
        right = Wd[lp, w:]
        U12 = torch.linalg.solve_triangular(lu_pan[:w], right[:w], upper=False,
                                            unitriangular=True)
        Wd[w:, w:].copy_(right[w:] - _dot(lu_pan[w:], U12))
        Wd[:w, w:].copy_(U12)
        Wd[:, :w].copy_(lu_pan)
        perm[off:off + W1] = perm[off:off + W1][lp]
        lperms[k] = lperm
    return Gp[:n, :n], lperms, perm[:n], w


def band_getrs(LU: torch.Tensor, lperms: torch.Tensor, w: int, kl: int, ku: int,
               B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B from band_getrf's interleaved-pivot factorization
    (reference: src/gbtrs.cc): the forward sweep replays, per window,
    the local row swap followed by the window's unit-L elimination; the
    back sweep is the U band solve via index reversal."""
    n, nrhs = B.shape
    steps, W1 = lperms.shape
    npad = steps * w + W1
    Lp = _pad_splice(LU, npad, npad, n)
    Yp = torch.nn.functional.pad(B.to(LU.dtype), (0, 0, 0, npad - n))
    lps = lperms.long()
    for k in range(steps):
        off = k * w
        ywin = Yp[off:off + W1][lps[k]]
        Wd = Lp[off:off + W1, off:off + w]
        y1 = torch.linalg.solve_triangular(Wd[:w], ywin[:w], upper=False,
                                           unitriangular=True)
        Yp[off + w:off + W1].copy_(ywin[w:] - _dot(Wd[w:], y1))
        Yp[off:off + w].copy_(y1)
    # the reversed U: band_trsm_lower reads only the lower triangle of
    # flip(LU), which is flip(triu(LU)), so LU's multipliers are not read
    X = band_trsm_lower(torch.flip(LU, (0, 1)), torch.flip(Yp[:n], (0,)), kl + ku)
    return torch.flip(X, (0,)).to(B.dtype)
