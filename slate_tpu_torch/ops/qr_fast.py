"""Native blocked and recursive Householder QR schedules (reference:
src/geqrf.cc:150-220: local panel factor, compact-WY T, trailing larfb
with the trailing products dominating), the counterpart of the JAX
package's ``ops/qr_fast.py``:

* micro level (``_qr_panel_strips``): ib-wide strips of an (m, w) panel;
  a column a larfg reflector and a rank-1 update of the strip's tail; a
  strip a compact-WY T (plain ``larft``) and one block-reflector
  application to the rest of the panel.
* panel level (``_block_qr``): the nb-wide panels of an (m, W) coarse
  block, each rolled to the top of the active region and applied to the
  rest of the block; the per-panel T factors are stacked.
* coarse level (``geqrf_fast``): at most ``coarse_panels`` blocks, each
  finished block's panels applied to the remaining columns.
* the recursive schedule (``geqrf_recursive``): the column halving of
  Elmroth & Gustavson with panel-width compact-WY factors and the
  zero-row pad to the canonical lattice heights; its ``pallas`` family
  assembles the base case's T through the Hopper ``larft`` kernel.
* ``resolve_qr_schedule`` and the mirrors ``geqrf_schedule_flops`` (equal
  to the JAX package's for the same arguments) and
  ``geqrf_kernel_launches``.

Every routine returns the LAPACK geqrf layout (V unit-lower below the
diagonal, R on and above) and the taus.  The column loop of
``_qr_panel_strips`` is a Python loop of small device operations with no
host synchronisation; under JAX it is traced once, here it runs eagerly,
dozens of launches a column.  Large products go to ``torch.matmul``
(TF32 off).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..internal.precision import hdot as _dot
from .chol_kernels import RECURSIVE_MIN_N, _lat_height, split_point
from .hopper import panel_kernels as pk
from .householder import _larfg, apply_block_reflector, larft, materialize_v


def _qr_panel_strips(P: torch.Tensor, ib: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Householder QR of an (m, w) panel whose elimination rows coincide
    with the column indices (callers roll the active region to the top).
    w must be a multiple of ib.  Returns (P, taus): V below the diagonal,
    R on and above.

    A column's reflector touches rows jc and below only, so its norm and
    update run on those rows (the JAX package masks the full height; the
    values are the same).  The strip's block reflector goes to the
    panel's columns right of the strip only."""
    m, w = P.shape
    P = P.clone()
    taus = P.new_zeros(w)
    for j0 in range(0, w, ib):
        S = P[:, j0:j0 + ib]  # a view: the strip is factored in place
        for c in range(ib):
            jc = j0 + c
            x = S[jc:, c]
            tail_x = x[1:]
            xnorm_sq = torch.vdot(tail_x, tail_x).real
            beta, tau, scale = _larfg(x[0], xnorm_sq, P.dtype)
            v_tail = tail_x * scale
            if c + 1 < ib:
                # apply H^H = I - conj(tau) v v^H to the strip's tail
                tail = S[jc:, c + 1:]
                wrow = tail[0] + v_tail.conj() @ tail[1:]
                tail[0] -= tau.conj() * wrow
                tail[1:] -= torch.outer(v_tail * tau.conj(), wrow)
            x[1:] = v_tail
            x[0] = beta
            taus[jc] = tau
        if j0 + ib < w:
            V = materialize_v(S[j0:])
            T = larft(V, taus[j0:j0 + ib])
            P[j0:, j0 + ib:] = apply_block_reflector(V, T, P[j0:, j0 + ib:], trans=True)
    return P, taus


def _block_qr(B: torch.Tensor, nb: int, ib: int = 32
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Householder QR of the first W columns of an (m, W) block, m >= W,
    one panel of nb at a time, each rolled to the top of the active
    region (the JAX package's single compiled shape; here the same
    masked full-height steps).

    Returns (B, taus, Tstack): B in geqrf layout, Tstack the (W // nb,
    nb, nb) compact-WY factors (reused by the coarse trailing applies)."""
    m, W = B.shape
    rows = torch.arange(m, device=B.device)
    colsW = torch.arange(W, device=B.device)
    nt = W // nb
    B = B.clone()
    taus = B.new_zeros(W)
    Tstack = B.new_zeros((nt, nb, nb))
    for s in range(nt):
        j0 = s * nb
        rolled = torch.roll(B[:, j0:j0 + nb], -j0, dims=0)
        rolled = torch.where((rows < m - j0)[:, None], rolled, 0)
        Pf, ptaus = _qr_panel_strips(rolled, ib)
        neu = torch.where((rows >= j0)[:, None], torch.roll(Pf, j0, dims=0), B[:, j0:j0 + nb])
        B[:, j0:j0 + nb] = neu
        taus[j0:j0 + nb] = ptaus
        V = materialize_v(neu, offset=j0)
        T = larft(V, ptaus)
        Tstack[s] = T
        # apply to the rest of the block (masked, full width)
        cmask = (colsW >= j0 + nb)[None, :]
        W1 = _dot(V.mH, torch.where(cmask, B, 0))
        B -= torch.where(cmask, _dot(V, _dot(T.mH, W1)), 0)
    return B, taus, Tstack


def geqrf_fast(G: torch.Tensor, nb: int = 512, ib: int = 128,
               coarse_panels: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked Householder QR of an (m, n) tensor, m >= n, n a multiple
    of nb.  Returns (G_factored, taus) in LAPACK geqrf layout."""
    m, n = G.shape
    if m < n or n % nb != 0:
        raise ValueError(f"geqrf_fast: bad shape {(m, n)} nb={nb}")
    # at least 4 strips a panel, or the strip-level compact-WY applies
    # degenerate into the per-column tail path
    ib = min(ib, max(nb // 4, 32))
    nt = n // nb
    if nt <= 1:
        return _qr_panel_strips(G, ib)
    G = G.clone()
    taus = G.new_zeros(n)
    NB = nb * (-(-nt // coarse_panels))
    k0 = 0
    while k0 < n:
        W = min(NB, n - k0)
        Bf, btaus, Tstack = _block_qr(G[k0:, k0:k0 + W], nb, ib)
        G[k0:, k0:k0 + W] = Bf
        taus[k0:k0 + W] = btaus
        if n - k0 - W > 0:
            C = G[k0:, k0 + W:]
            for p in range(W // nb):
                Vp = materialize_v(Bf[:, p * nb:(p + 1) * nb], offset=p * nb)
                C = apply_block_reflector(Vp, Tstack[p], C, trans=True)
            G[k0:, k0 + W:] = C
        k0 += W
    return G, taus


# ---------------------------------------------------------------------------
# Recursive (divide & conquer) schedule (Elmroth & Gustavson, "Applying
# recursion to serial and parallel QR factorization", IBM JRD 44(4),
# 2000): factor the left column half recursively, apply its nb_switch-wide
# compact-WY panels to the right half, recurse on the trailing block.  The
# T factors stay at panel width, as in E&G's hybrid.
# ---------------------------------------------------------------------------


def _pick_ib(w: int, ib: int) -> int:
    for d in (ib, 32, 16, 8, 4, 2, 1):
        if d <= ib and w % d == 0:
            return d
    return 1


def _geqrf_rec(G: torch.Tensor, nb_switch: int, ib: int, family: str = "recursive"):
    """Returns (G_factored, taus, panels): panels = [(offset, w, T)] for
    each nb_switch-wide base panel, T its compact-WY factor in the frame
    of G (reflector j of the panel eliminates row offset + j).  The
    ``pallas`` family assembles the base case's T through the Hopper
    ``larft`` kernel, the ``recursive`` family through the plain version;
    the strips' own T factors are always plain, as in the JAX package."""
    m, n = G.shape
    if n <= nb_switch:
        P, taus = _qr_panel_strips(G, _pick_ib(n, ib))
        T = (pk.larft if family == "pallas" else larft)(materialize_v(P), taus)
        return P, taus, [(0, n, T)]
    s = split_point(n)
    F1, t1, P1 = _geqrf_rec(G[:, :s], nb_switch, ib, family)
    # the left half's panels on the right half, oldest first; V full
    # height (zeros above the panel offset), as in the JAX package
    C = G[:, s:]
    for off, w, T in P1:
        V = materialize_v(F1[:, off:off + w], offset=off)
        C = apply_block_reflector(V, T, C, trans=True)
    # the trailing block at its canonical lattice height: the zero row pad
    # keeps R, taus and the reflectors (exact zeros in the pad rows)
    mc = _lat_height(m - s)
    C2 = C[s:]
    if mc > m - s:
        C2 = torch.nn.functional.pad(C2, (0, 0, 0, mc - (m - s)))
    F2, t2, P2 = _geqrf_rec(C2.contiguous(), nb_switch, ib, family)
    out = torch.cat([F1, torch.cat([C[:s], F2[:m - s]], dim=0)], dim=1)
    panels = P1 + [(off + s, w, T) for off, w, T in P2]
    return out, torch.cat([t1, t2]), panels


def geqrf_recursive(G: torch.Tensor, nb_switch: int = 256, ib: int = 32,
                    family: str = "recursive") -> Tuple[torch.Tensor, torch.Tensor]:
    """Divide & conquer blocked Householder QR of (m, n), m >= n, any n.
    Returns (G_factored, taus) in LAPACK geqrf layout.  A height off the
    canonical lattice is zero-padded to it first (QR of [A; 0] has the
    same R and taus, and exact zeros in the pad rows of V)."""
    m, n = G.shape
    if m < n:
        raise ValueError(f"geqrf_recursive: need m >= n, got {(m, n)}")
    mc = _lat_height(m)
    G = G.contiguous()  # the kernel reads rows with inner stride 1
    if mc != m:
        F, taus, _ = _geqrf_rec(torch.nn.functional.pad(G, (0, 0, 0, mc - m)), nb_switch, ib,
                                family)
        return F[:m], taus
    F, taus, _ = _geqrf_rec(G, nb_switch, ib, family)
    return F, taus


def geqrf_pallas(G: torch.Tensor, nb_switch: int = 256, ib: int = 32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recursive schedule with the base case's T on the Hopper
    ``larft`` kernel."""
    return geqrf_recursive(G, nb_switch, ib, family="pallas")


def flat_nb(n: int) -> int:
    """The block size of the flat schedule for width n (the 512/256/128
    ladder), 0 when no flat tiling exists."""
    for nbf in (512, 256, 128):
        if n % nbf == 0:
            return nbf
    return 0


def geqrf_flat(G: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flat schedule at its own block-size pick: the explicit
    ``Schedule.Flat`` entry point, honoured on every device."""
    return geqrf_fast(G, flat_nb(G.shape[1]))


def resolve_qr_schedule(m: int, n: int, dtype, schedule: str = "auto", device="cpu") -> str:
    """The route the QR dispatch takes for this shape, dtype and device,
    shared by drivers/qr.geqrf's kernel choice and its FLOP accounting.
    Explicit ``recursive``/``pallas`` (m >= n) and ``flat`` (tiled
    shapes) are honoured on every device (on the CPU the kernel's plain
    version runs).  ``auto``: on a CUDA device the pallas family for
    m >= n and n >= 2048, the flat schedule for tiled shapes with
    n >= 1024, the library QR otherwise; on the CPU the library QR.  A
    dtype the kernels do not take on a CUDA device (complex) runs the
    pallas family's schedule as ``recursive`` (the plain larft)."""
    tiled = m >= n and flat_nb(n) > 0
    if schedule in ("recursive", "pallas") and m >= n:
        route = schedule
    elif schedule == "flat" and tiled:
        return "flat"
    elif schedule == "auto" and torch.device(device).type != "cpu" and m >= n \
            and n >= RECURSIVE_MIN_N:
        route = "pallas"
    elif schedule == "auto" and torch.device(device).type != "cpu" and n >= 1024 and tiled:
        return "flat"
    else:
        return "vendor"
    if route == "pallas" and not pk.kernels_take(dtype, device):
        return "recursive"
    return route


def _rec_widths(n: int, nb_switch: int) -> List[int]:
    """Base-panel widths of the column recursion, left to right."""
    if n <= nb_switch:
        return [n]
    s = split_point(n)
    return _rec_widths(s, nb_switch) + _rec_widths(n - s, nb_switch)


def geqrf_kernel_launches(n: int, nb_switch: int = 256) -> int:
    """``larft`` kernel launches of one ``pallas``-family QR of n columns
    (any height): one a base panel of the recursion."""
    return len(_rec_widths(n, nb_switch))


def geqrf_schedule_flops(m: int, n: int, nb: int = 512, schedule: str = "recursive",
                         nb_switch: int = 256, ib: int = 32, m_true: int | None = None,
                         n_true: int | None = None) -> dict:
    """(model, exec, units) FLOP accounting for one QR of (m, n), m >= n,
    mirroring the JAX package's executed schedule.  model = 2 n^2 (m -
    n/3), the LAPACK geqrf count, of the true problem (m_true, n_true)
    when given; the compact-WY T formation is counted in exec only."""
    mt, nt_ = (m_true or m), (n_true or n)
    model = 2.0 * float(nt_) * nt_ * (mt - nt_ / 3.0)
    if schedule == "vendor":
        return {"model": model, "exec": 2.0 * float(n) * n * (m - n / 3.0),
                "units": {("vendor_qr", m, n)}}

    panel_unit = "pallas_qr_panel" if schedule == "pallas" else "qr_panel"

    def base_flops(M, w):
        ibb = _pick_ib(w, ib)
        strips = max(w // ibb, 1)
        # a strip: micro rank-1s + two full-panel-width masked WY products
        ex = strips * (2.0 * M * ibb * ibb + 4.0 * M * ibb * w)
        ex += 2.0 * M * w * w + w**3 / 3.0  # larft (V^H V + solve)
        return ex, {(panel_unit, M, w)}

    if schedule == "flat":
        nbf = flat_nb(n) or (nb if n % nb == 0 else 128)
        nt = max(n // nbf, 1)
        NB = nbf * (-(-nt // 4))
        ex, units = 0.0, set()
        k0 = 0
        while k0 < n:
            W = min(NB, n - k0)
            M = m - k0
            for _ in range(W // nbf):
                fb, ub = base_flops(M, nbf)
                ex += fb + 4.0 * M * nbf * W  # full-width masked apply
                units |= ub
            units |= {("qr_apply", M, nbf, W)}
            rest = n - k0 - W
            if rest > 0:
                ex += (W // nbf) * 4.0 * M * nbf * rest
                units |= {("qr_apply", M, nbf, rest)}
            k0 += W
        return {"model": model, "exec": ex, "units": units}

    def rec(M, n):
        if n <= nb_switch:
            return base_flops(M, n)
        s = split_point(n)
        f1, u1 = rec(M, s)
        fa, ua = 0.0, set()
        for w in _rec_widths(s, nb_switch):
            # full-height apply: 2 products at (w, M, n - s) + the T multiply
            fa += 4.0 * M * w * (n - s) + 2.0 * w * w * (n - s)
            ua |= {("qr_apply", M, w, n - s)}
        Mc = _lat_height(M - s)
        f2, u2 = rec(Mc, n - s)
        return f1 + fa + f2, u1 | ua | u2

    ex, units = rec(_lat_height(m), n)
    return {"model": model, "exec": ex, "units": units}
