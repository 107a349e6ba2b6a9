"""Divide and conquer symmetric tridiagonal eigensolver (stedc), the
counterpart of the JAX package's ``ops/stedc.py`` (reference:
src/stedc.cc, stedc_deflate.cc, stedc_merge.cc laed4 secular roots,
stedc_secular.cc, stedc_solve.cc, stedc_sort.cc, stedc_z_vector.cc).

The merge tree runs bottom-up over log2(N) levels and every level's
merges run as ONE batch: each phase function below takes a leading
batch axis (the JAX package ``vmap``s the unbatched ones).  The laed4
secular roots are found by vectorised geometric bisection + Newton for
all roots of all merges at once, deflation is masked arithmetic, and the
O(n^3) back-rotation is a batched product.

Numerical devices (as LAPACK dlaed3/dlaed4):

* secular roots in pole-shifted coordinates mu = lambda - d_i, so
  lambda - d_j = (d_i - d_j) + mu stays accurate for the vectors;
* the z-vector recomputed from the roots by the Lowner formula
  (Gu-Eisenstat), which keeps the vectors orthogonal for clustered poles;
* deflation: (a) tiny rho |z_j| passes the pair through, (b) near-equal
  pole pairs are combined by Givens rotations in alternating even/odd
  passes.  The JAX package's ``lax.while_loop`` over the passes is a
  Python loop here that reads one flag from the device a pass; a merge
  whose passes went quiet keeps its state while the others go on, as
  under ``vmap``.

The subproblem boundary adjustment (Cuppen subtracts |e_m| from both
boundary diagonals) telescopes over the full binary tree: the size-1
leaves start from d_j - |e_{j-1}| - |e_j|.

The deflation tolerance uses the dtype's IEEE eps on every device (the
JAX package widens it off the CPU for the TPU's emulated float64; CUDA
float64 is native).  ``_opt_barrier`` (an XLA fusion guard) has no
counterpart.

The padding poles of a non-power-of-two n lie in [2 bound, 3 bound),
bound / N apart.  The JAX package spaces them bound apart, up to
(N - n + 1) bound, and a merge's deflation tolerance 8 eps max|D| grows
with them: its eigenvector residuals then pass 10 n eps ||T||_1 at
n = 80-600 (tests/test_torch_stedc.py), and the SVD's Jordan-Wielandt
split turns that into a loss of orthogonality.  Padding poles always
deflate (their coupling weight is zero), so their values reach only
that tolerance and the final sort.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..internal.precision import hdot as _dot

_BISECT = 18  # geometric bisection phase: localises to ~2e-4 relative
_NEWTON = 10  # hybrid Newton/geometric phase: eps from there

_TINY = 1e-30


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, i]] for (B, n2) x and idx."""
    return torch.gather(x, 1, idx)


def _take_rows(Q: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Q[b, idx[b, i], :] for (B, n2, n2) Q."""
    return torch.gather(Q, 1, idx[:, :, None].expand(-1, -1, Q.shape[2]))


def _next_index(mask: torch.Tensor) -> torch.Tensor:
    """(B, n2): index of the next True entry strictly after i (n2 if none)."""
    B, n2 = mask.shape
    idx = torch.arange(n2, device=mask.device)
    posn = torch.where(mask, idx, n2)
    suf = torch.flip(torch.cummin(torch.flip(posn, [1]), 1).values, [1])
    return torch.cat([suf[:, 1:], torch.full((B, 1), n2, device=mask.device)], 1)


def _secular_roots(D, z2, rho, nondefl, nxt_idx, gap_hi):
    """Vectorised secular roots with nearest-pole shifting (the laed4
    numerics, reference: src/stedc_merge.cc:23-31 / LAPACK dlaed4), for a
    batch of merges: every argument has a leading batch axis.

    The root of f(lam) = 1 + rho sum_j z2_j / (D_j - lam) in
    (D_i, D_i + gap_hi_i) is located as lam = D[k_i] + sgn_i x_i, with
    k_i the nearer bracket pole (the sign of f at the midpoint) and
    x_i > 0 found by geometric bisection (relative precision) and a
    keep-best Newton polish.  Returns (kshift, sgn, x)."""
    B, n2 = D.shape
    dt, dev = D.dtype, D.device
    idx = torch.arange(n2, device=dev).expand(B, n2)
    rho_ = rho[:, None]
    nd = nondefl[:, None, :]
    z2_ = z2[:, None, :]

    def f_terms(den, power):
        safe = torch.where(den == 0, _TINY, den)
        return torch.where(nd, z2_ / (safe if power == 1 else safe * safe), 0).sum(2)

    mid = D + 0.5 * gap_hi
    has_upper = nxt_idx < n2
    f_mid = 1.0 + rho_ * f_terms(D[:, None, :] - mid[:, :, None], 1)
    right = has_upper & (f_mid < 0)  # the root lies in the upper half
    kshift = torch.where(right, nxt_idx.clamp(max=n2 - 1), idx)
    one = torch.ones((), dtype=dt, device=dev)
    sgn = torch.where(right, -one, one)
    Ds = _take(D, kshift)
    # the offset's span: shift pole to midpoint; the last root (no upper
    # pole) keeps its full interval
    span = torch.where(right, Ds - mid, torch.where(has_upper, mid - D, gap_hi))
    span = span.clamp(min=_TINY)
    # f entirely in shifted coordinates: den = (D_j - D_s) - sgn x
    deltaS = D[:, None, :] - Ds[:, :, None]

    def fx(x):
        return 1.0 + rho_ * f_terms(deltaS - (sgn * x)[:, :, None], 1)

    def fpx(x):
        return rho_ * f_terms(deltaS - (sgn * x)[:, :, None], 2)

    # "root is above x" <=> f(x) has the sign it takes near the pole
    pole_sign = torch.where(right, one, -one)
    lo = torch.clamp(span * 1e-25, min=1e-34)
    hi = span
    for _ in range(_BISECT):
        x = torch.sqrt(lo) * torch.sqrt(hi)
        toward = fx(x) * pole_sign > 0
        lo, hi = torch.where(toward, x, lo), torch.where(toward, hi, x)
    x = torch.sqrt(lo) * torch.sqrt(hi)
    # bracket-kept hybrid Newton with geometric fallback and keep-best
    x_best = x
    fbest = torch.full_like(x, 1e30)
    for _ in range(_NEWTON):
        fm = fx(x)
        toward = fm * pole_sign > 0
        lo, hi = torch.where(toward, x, lo), torch.where(toward, hi, x)
        ab = fm.abs()
        better = ab < fbest
        x_best = torch.where(better, x, x_best)
        fbest = torch.where(better, ab, fbest)
        xn = x - sgn * fm / fpx(x).clamp(min=_TINY)
        bad = ~torch.isfinite(xn) | (xn <= lo) | (xn >= hi)
        x = torch.where(bad, torch.sqrt(lo) * torch.sqrt(hi), xn)
    x = torch.where(fx(x).abs() < fbest, x, x_best)
    return kshift, sgn, x


def _merge_setup(w1, QT1, w2, QT2, e_r, eps):
    """Phase 0 of a batch of Cuppen merges: (D, z, QT) of the rank-one
    coupled problem with the poles sorted ascending.  Eigenvector blocks
    are carried transposed (row i of QT belongs to w[i]), so every
    permutation and Givens pass moves rows."""
    B, s = w1.shape
    dt, dev = w1.dtype, w1.device
    sigma = torch.where(e_r < 0, -1.0, 1.0).to(dt)
    rho = e_r.abs()
    D = torch.cat([w1, w2], 1)
    z = torch.cat([sigma[:, None] * QT1[:, :, -1], QT2[:, :, 0]], 1)
    QT = torch.zeros((B, 2 * s, 2 * s), dtype=dt, device=dev)
    QT[:, :s, :s] = QT1
    QT[:, s:, s:] = QT2
    order = torch.argsort(D, dim=1, stable=True)
    D, z, QT = _take(D, order), _take(z, order), _take_rows(QT, order)
    scale = torch.maximum(D.abs().amax(1), rho * (z * z).sum(1))
    tol = 8.0 * eps * scale.clamp(min=_TINY)
    return D, z, QT, rho, tol


def _deflate(D, z, QT, rho, tol):
    """Deflation phases (a) and (b) of a batch of merges: drop negligible
    coupling weight, and combine near-equal pole pairs by Givens passes
    (rank pairing halves an equal-pole run a pass)."""
    B, n2 = D.shape
    dev = D.device
    idx = torch.arange(n2, device=dev).expand(B, n2)
    rho_, tol_ = rho[:, None], tol[:, None]
    nondefl = rho_ * z.abs() > tol_
    # stop a merge after TWO consecutive quiet passes (the parities
    # alternate); most merges need 0-2 passes, degenerate clusters use the
    # whole budget
    npass = max(4, 2 * int(np.ceil(np.log2(n2))) + 2)
    quiet1 = torch.zeros(B, dtype=torch.bool, device=dev)  # last pass quiet
    quiet2 = torch.zeros_like(quiet1)  # the pass before quiet
    for p in range(npass):
        live = ~(quiet1 & quiet2)
        if not bool(live.any()):
            break
        # pair nondeflated entries by their rank among the nondeflated
        # (even rank leads, its next nondeflated neighbour follows), with
        # the parity alternating a pass
        rank = torch.cumsum(nondefl.to(torch.int64), 1) - 1
        nxt_nd = _next_index(nondefl)
        posp = torch.where(nondefl, idx, -1)
        prv_nd = torch.cat([torch.full((B, 1), -1, device=dev),
                            torch.cummax(posp, 1).values[:, :-1]], 1)
        is_lead = nondefl & (rank % 2 == p % 2) & (nxt_nd < n2)
        nxt_c = nxt_nd.clamp(0, n2 - 1)
        act_lead = is_lead & ((_take(D, nxt_c) - D).abs() <= tol_)
        is_fol = nondefl & (rank % 2 != p % 2)
        prv_c = prv_nd.clamp(0, n2 - 1)
        lead = torch.where(is_fol, prv_c, idx)
        act = torch.where(is_fol, _take(act_lead, prv_c) & (prv_nd >= 0), act_lead)
        act = act & (is_lead | is_fol) & live[:, None]
        fol = _take(nxt_nd, lead).clamp(0, n2 - 1)
        zl, zf = _take(z, lead), _take(z, fol)
        r = torch.sqrt(zl * zl + zf * zf)
        rsafe = torch.where(r == 0, 1.0, r)
        c, sn = zl / rsafe, zf / rsafe
        z = torch.where(act, torch.where(is_lead, r, 0.0), z)
        Dl, Df = _take(D, lead), _take(D, fol)
        D = torch.where(act, torch.where(is_lead, c * c * Dl + sn * sn * Df,
                                         sn * sn * Dl + c * c * Df), D)
        # rotate eigenvector pairs (rows of QT):
        #   lead <- c q_l + s q_f, fol <- -s q_l + c q_f
        ql, qf = _take_rows(QT, lead), _take_rows(QT, fol)
        c3, s3 = c[:, :, None], sn[:, :, None]
        Qrot = torch.where(is_lead[:, :, None], c3 * ql + s3 * qf, -s3 * ql + c3 * qf)
        QT = torch.where(act[:, :, None], Qrot, QT)
        nondefl = nondefl & ~(act & is_fol)
        quiet2 = torch.where(live, quiet1, quiet2)
        quiet1 = torch.where(live, ~act.any(1), quiet1)
    # re-apply deflation (a) after the rotations moved the weight
    nondefl = nondefl & (rho_ * z.abs() > tol_)
    z = torch.where(nondefl, z, 0.0)
    return D, z, QT, nondefl


def _solve_secular(D, z, rho, nondefl, tol):
    """Secular-equation phase: brackets and the vectorised laed4 roots.
    Returns (kshift, sgn, x, lam)."""
    B, n2 = D.shape
    idx = torch.arange(n2, device=D.device).expand(B, n2)
    z2 = z * z
    nxt_idx = _next_index(nondefl)  # next nondeflated pole above i
    nxt_c = nxt_idx.clamp(0, n2 - 1)
    top_gap = rho * z2.sum(1) + tol
    gap_hi = torch.where(nxt_idx < n2, _take(D, nxt_c) - D, top_gap[:, None])
    gap_hi = gap_hi.clamp(min=_TINY)
    kshift, sgn, x = _secular_roots(D, z2, rho, nondefl, nxt_idx, gap_hi)
    kshift = torch.where(nondefl, kshift, idx)
    sgn = torch.where(nondefl, sgn, 1.0)
    x = torch.where(nondefl, x, 0.0)
    lam = torch.where(nondefl, _take(D, kshift) + sgn * x, D)
    return kshift, sgn, x, lam


def _assemble_u(D, z, nondefl, kshift, sgn, x):
    """Lowner z-hat recomputation and eigenvector assembly.  Returns Ur
    with ROWS indexed by root i, for the transposed back-rotation
    QT_out = Ur @ QT."""
    B, n2 = D.shape
    dt, dev = D.dtype, D.device
    # zhat_j^2 = prod_i (lam_i - D_j) / prod_{i != j} (D_i - D_j) over
    # nondeflated i, j; lam_i - D_j = (D[kshift_i] - D_j) + sgn_i x_i
    delta = D[:, :, None] - D[:, None, :]
    lam_minus_d = (_take(D, kshift)[:, :, None] - D[:, None, :]) + (sgn * x)[:, :, None]
    both = nondefl[:, :, None] & nondefl[:, None, :]
    eye = torch.eye(n2, dtype=torch.bool, device=dev)
    num = torch.where(both, lam_minus_d, 1.0)
    offdiag = both & ~eye
    den = torch.where(offdiag, delta, 1.0)
    logmag = torch.where(both, torch.log(torch.where(num == 0, 1.0, num).abs()), 0.0)
    logden = torch.where(offdiag, torch.log(torch.where(den == 0, 1.0, den).abs()), 0.0)
    logzhat = 0.5 * (logmag.sum(1) - logden.sum(1))
    zsign = torch.where(z < 0, -1.0, 1.0).to(dt)
    # column i (nondeflated): u_j = zhat_j / (lam_i - D_j), normalised,
    # assembled in log space so tiny zhat cannot underflow
    absd = lam_minus_d.abs()
    logd = torch.log(torch.where(absd == 0, 1.0, absd))
    logU = torch.where(both, logzhat[:, None, :] - logd, -torch.inf)
    sgn_u = zsign[:, None, :] * torch.where(lam_minus_d < 0, -1.0, 1.0)
    M = logU.amax(2, keepdim=True)
    Msafe = torch.where(torch.isfinite(M), M, 0.0)
    Ur = torch.where(both, sgn_u * torch.exp(logU - Msafe), 0.0)
    norms = torch.sqrt((Ur * Ur).sum(2))
    Ur = Ur / torch.where(norms == 0, 1.0, norms)[:, :, None]
    return torch.where(nondefl[:, :, None], Ur, eye.to(dt))  # deflated: unit vectors


def _merge(w1, QT1, w2, QT2, e_r, eps):
    """A batch of Cuppen merges: children (w1, QT1), (w2, QT2) of size s
    (QT in row-eigenvector form) coupled by e_r.  Returns (w, QT) of
    size 2s, ascending."""
    D, z, QT, rho, tol = _merge_setup(w1, QT1, w2, QT2, e_r, eps)
    D, z, QT, nondefl = _deflate(D, z, QT, rho, tol)
    kshift, sgn, x, lam = _solve_secular(D, z, rho, nondefl, tol)
    Ur = _assemble_u(D, z, nondefl, kshift, sgn, x)
    # back-rotation and final sort, in transposed form: QT_out = U^T QT
    QT = _dot(Ur, QT)
    order2 = torch.argsort(lam, dim=1, stable=True)
    return _take(lam, order2), _take_rows(QT, order2)


def stedc(d: torch.Tensor, e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of the symmetric tridiagonal (d, e): returns
    (w ascending, Q) with T = Q diag(w) Q^T.

    Bottom-up Cuppen tree over a power-of-two padding; each level's
    merges run as one batch (reference: src/stedc.cc's recursive driver
    and stedc_merge/stedc_secular)."""
    n = d.shape[0]
    dt, dev = d.dtype, d.device
    eps = float(torch.finfo(dt).eps)
    if n == 1:
        return d, torch.ones((1, 1), dtype=dt, device=dev)
    # normalise to O(1) scale, as LAPACK dlaed0 does
    emax = e.abs().max() if e.shape[0] else torch.zeros((), dtype=dt, device=dev)
    scale0 = torch.maximum(d.abs().max(), emax)
    scale = torch.where(scale0 > 0, scale0, 1.0)
    d, e = d / scale, e / scale
    emax = emax / scale
    N = 1 << int(np.ceil(np.log2(n)))
    # pad with decoupled, distinct poles above the spectrum, within 3
    # bound so that they do not widen the deflation tolerance
    bound = d.abs().max() + 2 * emax + 1.0
    dpad = torch.cat([d, bound * (2.0 + torch.arange(N - n, dtype=dt, device=dev) / N)])
    epad = torch.cat([e, torch.zeros(N - 1 - e.shape[0], dtype=dt, device=dev)])
    # leaf adjustment: every interior edge is cut once in the full tree
    eabs = epad.abs()
    zero = torch.zeros(1, dtype=dt, device=dev)
    w = (dpad - torch.cat([zero, eabs]) - torch.cat([eabs, zero]))[:, None]  # (N, 1)
    QT = torch.ones((N, 1, 1), dtype=dt, device=dev)
    s = 1
    while s < N:
        nm = N // (2 * s)
        wp = w.reshape(nm, 2, s)
        Qp = QT.reshape(nm, 2, s, s)
        e_r = epad[s - 1:: 2 * s][:nm]
        w, QT = _merge(wp[:, 0], Qp[:, 0], wp[:, 1], Qp[:, 1], e_r, eps)
        s *= 2
    w = w.reshape(N)
    QT = QT.reshape(N, N)[:n, :n]
    return w[:n] * scale, QT.T.contiguous()
