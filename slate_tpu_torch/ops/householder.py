"""Householder compact-WY utilities (reference: the T factors of
geqrf/unmqr, slate's TriangularFactors Tlocal, src/geqrf.cc:150-200,
internal_unmqr.cc; LAPACK larft/larfb semantics), the counterpart of the
JAX package's ``ops/householder.py``.

Q = H_0 H_1 ... H_{nb-1} = I - V T V^H with V unit-lower, T upper
triangular, T built from the identity

    T^{-1} = diag(1/tau) + strict_upper(V^H V)

(one small triangular inverse) instead of LAPACK's column recurrence.
tau == 0 (no reflector) columns take a large-diagonal limit that zeroes
their T row and column.

``geqrf`` is the dispatcher: the library QR (``torch.geqrf``, LAPACK on
the CPU, cuSOLVER/MAGMA on a CUDA device) except for large panels on a
CUDA device, which run the native flat schedule (ops/qr_fast.py), as the
JAX package does on its accelerator.  Every scalar of the column loops
stays a device tensor (``torch.where``, no ``.item()``), so the loops
never wait for the device.
"""

from __future__ import annotations

import torch

from ..internal.precision import hdot as _dot
from .hopper.panel_kernels import larft_plain as larft  # noqa: F401 (the plain assembly)


def geqrf(a: torch.Tensor):
    """LAPACK-style QR: returns (a_factored, taus) with V unit-lower below
    the diagonal and R on and above (row-major).

    The CPU keeps the library kernel; on a CUDA device an (m, n) panel
    with m >= n and n >= 1024 divisible by 512, 256 or 128 runs the
    native flat schedule ``qr_fast.geqrf_fast``."""
    m, n = a.shape
    if a.device.type != "cpu" and m >= n and n >= 1024:
        from .qr_fast import flat_nb, geqrf_fast

        nbf = flat_nb(n)
        if nbf:
            fac, taus = geqrf_fast(a, nbf)
            return fac, taus[: min(m, n)]
    fac, taus = torch.geqrf(a)
    # the library returns a column-major factor; the kernels read rows
    return fac.contiguous(), taus


def _larfg(alpha: torch.Tensor, xnorm_sq: torch.Tensor, dtype: torch.dtype):
    """Reflector scalar generation (LAPACK larfg) on 0-d device tensors:
    returns (beta, tau, scale) with v = x * scale below the pivot and
    v[0] = 1 implicit.  A zero column (norm 0) gives tau = 0."""
    a_re = alpha.real if dtype.is_complex else alpha
    norm = torch.sqrt((alpha * alpha.conj()).real + xnorm_sq)
    # sign(0) would be 0: a zero alpha takes the + sign, as LAPACK does
    beta = -torch.sign(torch.where(a_re == 0, 1.0, a_re)) * norm
    live = norm > 0
    beta = torch.where(live, beta, a_re).to(dtype)
    tau = torch.where(live, (beta - alpha) / beta, 0.0)
    scale = torch.where(live, 1.0 / torch.where(alpha == beta, 1.0, alpha - beta), 0.0)
    return beta, tau.to(dtype), scale.to(dtype)


def _geqrf_panel(P: torch.Tensor):
    """Unblocked right-looking Householder QR of an (m, w) panel, w <= m."""
    m, w = P.shape
    rows = torch.arange(m, device=P.device)
    cols = torch.arange(w, device=P.device)
    taus = P.new_zeros(w)
    for j in range(w):
        x = P[:, j]
        below = rows > j
        beta, tau, scale = _larfg(P[j, j], torch.where(below, x.abs() ** 2, 0).sum(), P.dtype)
        v = torch.where(below, x * scale, 0)
        v[j] = 1
        # eliminate with H^H = I - conj(tau) v v^H (LAPACK zgeqr2 applies
        # H(i)^H, passing conj(tau) to zlarf)
        w_row = v.conj() @ P
        upd = tau.conj() * v[:, None] * w_row[None, :]
        P = P - torch.where((cols >= j)[None, :], upd, 0)
        col = torch.where(below, v, P[:, j])
        col[j] = beta
        P[:, j] = col
        taus[j] = tau
    return P, taus


def geqrf_blocked(a: torch.Tensor, nb: int = 128):
    """Blocked Householder QR (the reference's geqrf panel + larfb
    structure, src/geqrf.cc) in plain tensor operations: each panel is
    rolled to the top, factored unblocked, and its block reflector
    applied to the columns right of it."""
    m, n = a.shape
    a = a.clone()
    kmax = min(m, n)
    taus = a.new_zeros(kmax)
    rows = torch.arange(m, device=a.device)
    for k0 in range(0, kmax, nb):
        w = min(nb, kmax - k0)
        active = (rows >= k0)[:, None]
        panel = torch.where(active, a[:, k0:k0 + w], 0)
        pfac, ptaus = _geqrf_panel(torch.roll(panel, -k0, dims=0))
        # rows < k0 keep their entries (they belong to earlier R rows)
        merged = torch.where(active, torch.roll(pfac, k0, dims=0), a[:, k0:k0 + w])
        a[:, k0:k0 + w] = merged
        taus[k0:k0 + w] = ptaus
        if k0 + w < n:
            V = torch.where(active, materialize_v(merged, offset=k0), 0)
            a[:, k0 + w:] = apply_block_reflector(V, larft(V, ptaus), a[:, k0 + w:], trans=True)
    return a, taus


def materialize_v(panel: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """Unit-lower V from a geqrf-factored panel (m, nb): zeros on and
    above the diagonal of the block starting at row ``offset``, ones on
    it."""
    m, nb = panel.shape
    rows = torch.arange(m, device=panel.device)[:, None]
    cols = torch.arange(nb, device=panel.device)[None, :] + offset
    V = torch.where(rows > cols, panel, 0)
    return torch.where(rows == cols, 1, V)


def apply_block_reflector(V: torch.Tensor, T: torch.Tensor, C: torch.Tensor,
                          trans: bool) -> torch.Tensor:
    """C <- (I - V T V^H) C (trans=False) or (I - V T^H V^H) C (True):
    LAPACK larfb, left side, full-precision products (TF32 off)."""
    W = _dot(V.mH, C)  # (nb, n)
    Tm = T.mH if trans else T
    return C - _dot(V, _dot(Tm, W))
