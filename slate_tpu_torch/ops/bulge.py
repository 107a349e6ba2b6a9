"""Stage-2 bulge chasing: band -> tridiagonal, the hb2st back-transform,
and tridiagonal eigenvalues by bisection; the counterpart of the JAX
package's ``ops/bulge.py``.

``hb2st`` is the superstep wavefront (reference: src/hb2st.cc:44-187):
task (sweep s, chase step j) runs at superstep t = 3s + j, so every
superstep executes a diagonal of independent tasks whose windows are
disjoint.  Where the JAX package runs one ``lax.fori_loop`` over the
supersteps with a ``vmap``ped window kernel, here a Python loop steps
the supersteps and each one chases its NSLOT windows as one batch:
one gather of the windows from the band storage, batched reflector and
two-sided updates, one scatter of NSLOT contiguous column slices back.
The schedule (window origins, validity, reflector slots) is computed
once on the host and uploaded, so no superstep waits for the device.

``unmtr_hb2st`` applies the chase reflectors by diamond-blocked
compact-WY blocks; ``_unmtr_hb2st_sweep`` is the per-sweep rank-1 form,
kept as its parity reference.  ``tridiag_eigvals_bisect`` bisects all n
eigenvalues at once with vectorised Sturm counts: a row loop over the
matrix per bisection step (n x ``max_iter`` steps of a few launches
each).

Band storage is lower-diagonal-major: W[d, c] = A[c+d, c] for
d = 0..2b (2b diagonals hold the transient bulges).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..internal.precision import hdot
from .householder import _larfg


def band_to_storage(G: torch.Tensor, b: int, n_pad: int) -> torch.Tensor:
    """Pack a (n, n) Hermitian band matrix (lower data) into (2b+1, n_pad)
    diagonal-major storage."""
    n = G.shape[0]
    W = G.new_zeros((2 * b + 1, n_pad))
    for d in range(min(b, n - 1) + 1):
        W[d, : n - d] = torch.diagonal(G, -d)
    return W


def realify(d: torch.Tensor, e_c: torch.Tensor, n: int):
    """Diagonal phase similarity making the subdiagonal real: returns
    (d, |e_c|, u) with u_0 = 1, u_{i+1} = u_i e_c[i] / |e_c[i]| (LAPACK
    zhbtrd's scaling); a real e_c keeps its signs and u = 1."""
    if not e_c.is_complex():
        return d, e_c, torch.ones(n, dtype=e_c.dtype, device=e_c.device)
    mag = e_c.abs()
    unit = torch.where(mag == 0, torch.ones_like(e_c), e_c / torch.where(mag == 0, 1, mag))
    u = torch.cat([torch.ones(1, dtype=e_c.dtype, device=e_c.device), torch.cumprod(unit, 0)])
    return d, mag, u


def _schedule(n: int, b: int, n_pad: int, device):
    """The wavefront's host-side schedule, uploaded once: for every
    superstep t and slot i, the clamped window origin w0c, the
    window-relative reflector row r0, validity, and the flat reflector
    slot s J1 + j (the dummy slot n_sweeps J1 for invalid windows)."""
    n_sweeps = n - 2
    jmax = (n - 3) // b + 1
    nslot = jmax // 3 + 2
    t_total = 3 * (n_sweeps - 1) + jmax + 1
    L = 3 * b + 1
    t = np.arange(t_total)[:, None]
    s = t // 3 - np.arange(nslot)[None, :]
    j = t - 3 * s
    row0 = s + j * b + 1
    valid = (s >= 0) & (s < n_sweeps) & (row0 <= n - 2)
    r0 = np.where(j == 0, 1, b)
    w0 = np.where(j == 0, s, s + (j - 1) * b + 1)
    w0c = np.where(valid, w0, n_pad - L)
    slot = np.where(valid, s * (jmax + 1) + j, n_sweeps * (jmax + 1))
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return up(w0c), up(r0), up(valid), up(slot), t_total, nslot, jmax


def hb2st(W: torch.Tensor, n: int, b: int):
    """Reduce a Hermitian band matrix (bandwidth b) to real symmetric
    tridiagonal by Householder bulge chasing.

    W: (2b+1, n_pad) diagonal-major lower band storage, n_pad >= n + 4b+8
    (not modified).  Returns (d, e, u, VS, TAUS): the real tridiagonal
    diagonal and subdiagonal, the unit diagonal phase u that made it
    real (``realify``; eigenvectors back-transform as Z_band =
    Q (u * Z_real)), and the chase reflectors for ``unmtr_hb2st``:
    VS[s, j] is the length-b reflector of sweep s, step j (v[0] = 1),
    acting on rows s + j b + 1 .. s + (j+1) b."""
    dtype, dev = W.dtype, W.device
    n_pad = W.shape[1]
    L = 3 * b + 1
    complex_t = dtype.is_complex

    def conj(x):
        return x.conj() if complex_t else x

    if n <= 2 or b <= 1:
        d = W[0, :n].real.clone() if complex_t else W[0, :n].clone()
        e_c = W[1, : n - 1].clone() if n > 1 else W.new_zeros(0)
        d, e, u = realify(d, e_c, n)
        return d, e, u, W.new_zeros((1, 1, max(b, 1))), W.new_zeros((1, 1))

    W = W.clone()
    n_sweeps = n - 2
    w0c_t, r0_t, valid_t, slot_t, t_total, nslot, jmax = _schedule(n, b, n_pad, dev)
    ar = lambda k: torch.arange(k, device=dev)  # noqa: E731
    # static index maps: densify (band strip -> dense L x L window) as one
    # flat gather of W, and bandify (dense window -> band strip)
    rr, cc = ar(L)[:, None], ar(L)[None, :]
    dmat = rr - cc
    lower_m = (dmat >= 0) & (dmat <= 2 * b)
    upper_m = (dmat < 0) & (-dmat <= 2 * b)
    dense_flat = dmat.abs().clamp(0, 2 * b) * n_pad + torch.where(dmat >= 0, cc, rr)
    dd, ar2b = ar(2 * b + 1)[:, None], ar(2 * b)[None, :]
    band_rows = (ar2b + dd).clamp(0, L - 1)  # (2b+1, 2b): the written columns only
    in_win = dd + ar2b <= L - 1
    bi = ar(nslot)[:, None]
    bi3 = bi[:, :, None]
    arb = ar(b)[None, :]
    Wflat = W.view(-1)
    VS = W.new_zeros((n_sweeps * (jmax + 1) + 1, b))  # + the dummy slot
    TAUS = W.new_zeros(n_sweeps * (jmax + 1) + 1)

    for t in range(t_total):
        w0, r0, valid = w0c_t[t], r0_t[t], valid_t[t]
        vals = Wflat[dense_flat[None] + w0[:, None, None]]  # (NSLOT, L, L)
        DW = torch.where(lower_m, vals, torch.where(upper_m, conj(vals), 0))
        # the chase: eliminate window-column 0 rows r0+1..r0+b-1 and apply
        # the two-sided update (the PLASMA hb2st type-1/2/3 kernels fused)
        rows = r0[:, None] + arb  # (NSLOT, b)
        x = DW[bi, rows, 0]
        beta, tau, scale = _larfg(x[:, 0], (x[:, 1:].abs() ** 2).sum(1), dtype)
        v = x * scale[:, None]
        v[:, 0] = 1
        S = DW[bi, rows, :]  # left: rows R <- H^H rows, H = I - tau v v^H
        S = S - conj(tau)[:, None, None] * v[:, :, None] * hdot(conj(v)[:, None, :], S)
        DW[bi, rows, :] = S
        S2t = DW[bi, :, rows]  # right: cols R <- cols H; S2t[k, m, r] = DW[k, r, R_m]
        y = hdot(v[:, None, :], S2t)  # (S2 v)^T
        DW[bi, :, rows] = S2t - tau[:, None, None] * conj(v)[:, :, None] * y
        newcol = torch.zeros_like(x)
        newcol[:, 0] = beta
        DW[bi, rows, 0] = newcol
        DW[bi, 0, rows] = conj(newcol)
        # write back ONLY the 2b stored columns a task can modify: its
        # rows/cols R = [w0+r0, w0+r0+b-1] (r0 <= b) put every modified
        # entry W[d, c] at c <= w0 + 2b - 1.  Concurrent windows sit 3b-1
        # columns apart, so these slices are disjoint.  Invalid windows
        # were clamped to w0 = n_pad - L; they write ZEROS there (not
        # their dummy chase output): the clamp region overlaps the read
        # range of late valid windows for b > 8, and it is zero padding.
        cols = w0[:, None] + ar2b  # (NSLOT, 2b)
        blk = torch.where(in_win, DW[bi3, band_rows, ar2b], W[:, cols].transpose(0, 1))
        W[:, cols] = torch.where(valid[:, None, None], blk, 0).transpose(0, 1)
        VS[slot_t[t]] = v
        TAUS[slot_t[t]] = tau

    VS = VS[:-1].view(n_sweeps, jmax + 1, b)
    TAUS = TAUS[:-1].view(n_sweeps, jmax + 1)
    d = W[0, :n].real.clone() if complex_t else W[0, :n].clone()
    d, e, u = realify(d, W[1, : n - 1].clone(), n)
    return d, e, u, VS, TAUS


def _unmtr_hb2st_sweep(VS: torch.Tensor, TAUS: torch.Tensor, Z: torch.Tensor, n: int, b: int,
                       trans: bool = False) -> torch.Tensor:
    """Per-sweep rank-1 hb2st back-transform, the parity reference of the
    diamond-blocked path below.  Reflectors of one sweep act on disjoint
    row blocks that tile the contiguous range [s+1, s+1+J1 b), so each
    sweep is one batched application; sweeps run in reverse order for
    Q Z.  Rows past n - 1 fall in zero padding where VS/TAUS are zero."""
    if VS.shape[0] <= 1 and n <= 2:
        return Z
    n_sweeps, J1, _ = VS.shape
    m = Z.shape[1]
    complex_t = Z.dtype.is_complex
    conj = (lambda x: x.conj()) if complex_t else (lambda x: x)
    Zp = F.pad(Z, (0, 0, 0, b + J1 * b + 8))
    for k in range(n_sweeps):
        s = k if trans else n_sweeps - 1 - k
        v, tau = VS[s], TAUS[s]
        tau = conj(tau) if trans else tau
        Zr = Zp[s + 1: s + 1 + J1 * b].view(J1, b, m)
        wrow = hdot(conj(v)[:, None, :], Zr)  # (J1, 1, m)
        Zr -= tau[:, None, None] * v[:, :, None] * wrow
    return Zp[: Z.shape[0]]


def unmtr_hb2st(VS: torch.Tensor, TAUS: torch.Tensor, Z: torch.Tensor, n: int, b: int,
                trans: bool = False) -> torch.Tensor:
    """Apply the hb2st back-transform: Z <- Q Z (trans=False) or Q^H Z
    (reference: src/unmtr_hb2st.cc), Q = product of all chase reflectors
    in execution order.

    Diamond-blocked compact-WY apply (the MAGMA/PLASMA blocking): the
    reflectors of nbl = b consecutive sweeps at the same chase step j
    start on consecutive rows, so they form a trapezoidal (b+nbl-1, nbl)
    block reflector whose T factor turns nbl rank-1 updates into two
    products.  Schedule: sweep-blocks ascending, chase step j descending
    within a block for Q^H Z; the exact reverse for Q Z.  T factors come
    from T^{-1} = diag(1/tau) + striu(V^H V) (one batched Gram product
    and one batched triangular solve); tau == 0 columns get v = 0 and a
    unit diagonal, exact identity factors."""
    n_sweeps, J1, _ = VS.shape
    if n_sweeps < 1 or n <= 2 or b <= 1:  # hb2st's placeholder: Q == I
        return Z
    m = Z.shape[1]
    dtype, dev = Z.dtype, Z.device
    nbl = b
    nblk = -(-n_sweeps // nbl)
    ns_pad = nblk * nbl
    h = b + nbl - 1
    VSp = F.pad(VS, (0, 0, 0, 0, 0, ns_pad - n_sweeps))
    TAUSp = F.pad(TAUS, (0, 0, 0, ns_pad - n_sweeps))
    VSp = torch.where(TAUSp[:, :, None] != 0, VSp, 0)
    VSb = VSp.view(nblk, nbl, J1, b).permute(0, 2, 1, 3)
    TB = TAUSp.view(nblk, nbl, J1).permute(0, 2, 1)  # (nblk, J1, nbl)
    # shift sweep i of a diamond down i rows: padding the rows to width
    # h+1 and re-flattening is that shift (out flat index i h + (i + r) ==
    # in flat index i (h+1) + r), so the trapezoid builds with no scatter
    Vsh = F.pad(VSb, (0, nbl)).reshape(nblk, J1, nbl * (h + 1))[:, :, : nbl * h]
    DV = Vsh.reshape(nblk, J1, nbl, h).transpose(-1, -2)  # (nblk, J1, h, nbl)
    G = hdot(DV.mH, DV)
    ones = torch.ones_like(TB)
    invtau = torch.where(TB == 0, ones, 1.0 / torch.where(TB == 0, ones, TB))
    eye = torch.eye(nbl, dtype=dtype, device=dev)
    Tinv = torch.triu(G, 1) + invtau[..., None] * eye
    Tf = torch.linalg.solve_triangular(Tinv, eye.expand_as(Tinv), upper=True)
    Zp = F.pad(Z, (0, 0, 0, ns_pad + J1 * b + h - Z.shape[0]))
    for t in range(nblk * J1):
        if trans:
            k, j = t // J1, J1 - 1 - t % J1
        else:
            k, j = nblk - 1 - t // J1, t % J1
        r0 = k * nbl + 1 + j * b
        V, Tm = DV[k, j], Tf[k, j]
        Tm = Tm.mH if trans else Tm  # P^H = I - V T^H V^H
        S = Zp[r0: r0 + h]
        S -= hdot(V, hdot(Tm, hdot(V.mH, S)))
    return Zp[: Z.shape[0]]


def tridiag_eigvals_bisect(d: torch.Tensor, e: torch.Tensor, max_iter: int = 64) -> torch.Tensor:
    """All eigenvalues of a real symmetric tridiagonal by bisection with
    vectorised Sturm counts (reference: sterf.cc's role; LAPACK dstebz's
    algorithm with every eigenvalue bisected in parallel and each
    iteration one pass over the matrix's rows)."""
    n = d.shape[0]
    if n == 1:
        return d
    dt, dev = d.dtype, d.device
    e2 = e * e
    # pivot floor (dstebz's pivmin role), scale-relative as in the JAX
    # package
    scale_p = torch.clamp(torch.maximum(d.abs().max(), e2.max()), min=1.0)
    pivmin = scale_p * 1e-30
    zero = torch.zeros(1, dtype=dt, device=dev)
    ae = e.abs()
    rad = torch.cat([ae, zero]) + torch.cat([zero, ae])
    lo0, hi0 = (d - rad).min(), (d + rad).max()
    span = torch.clamp(hi0 - lo0, min=1.0)
    lo = (lo0 - 1e-3 * span).expand(n).clone()
    hi = (hi0 + 1e-3 * span).expand(n).clone()
    ks1 = torch.arange(1, n + 1, device=dev)
    e2p = torch.cat([zero, e2])  # the first row does not subtract (q_{-1} = 1)
    neg_pivmin = -pivmin
    Q = torch.empty((n, n), dtype=dt, device=dev)
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        # Sturm count: #eigenvalues < mid[k], one pass over the rows.  The
        # pivot guard applies BEFORE the pivot is counted (dstebz): an
        # exactly-zero pivot is an eigenvalue of a leading minor and
        # tallies as negative
        Dm = d[:, None] - mid[None, :]
        q = torch.ones_like(mid)
        for i in range(n):
            qn = torch.addcdiv(Dm[i], e2p[i], q, value=-1)
            q = torch.where(qn.abs() < pivmin, neg_pivmin, qn, out=Q[i])
        go_left = (Q < 0).sum(0) >= ks1
        lo, hi = torch.where(go_left, lo, mid), torch.where(go_left, mid, hi)
    return 0.5 * (lo + hi)
