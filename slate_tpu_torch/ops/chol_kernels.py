"""Native blocked and recursive Cholesky schedules (reference:
src/potrf.cc:84-209), the counterpart of the JAX package's
``ops/chol_kernels.py``:

* ``chol_unblocked`` — ib-strip Cholesky of one diagonal block.
* ``blocked_potrf``  — the two-level ``flat`` schedule, which ``auto``
  takes below ``RECURSIVE_MIN_N`` on a CUDA device.
* ``chol_recursive`` — divide and conquer on the halving lattice; the
  ``pallas`` family runs its base case and trailing update through the
  hand-written Hopper kernels in ``ops/hopper/panel_kernels.py``, the
  ``recursive`` family through plain tensor code.
* FLOP mirrors (``chol_schedule_flops``) and the kernel launch mirror
  (``chol_kernel_launches``): pure-Python walks of the schedules.
* ``cholesky`` — the schedule dispatcher with its pad to a multiple of
  128 and unit-diagonal splice.

Large solves and products inside the schedules go to
``torch.linalg.solve_triangular`` / ``torch.matmul`` (TF32 off), as the
JAX package leaves them to XLA.  Tensors stay on the device they came on.
"""

from __future__ import annotations

import torch

from ..internal.precision import hdot as _dot
from .hopper import panel_kernels as pk


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _zeros(m: int, n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((m, n), dtype=like.dtype, device=like.device)


def chol_unblocked(a: torch.Tensor, ib: int = 16) -> torch.Tensor:
    """Cholesky of one (b, b) block: L L^H = a, in strips of ib columns
    (each strip eliminated column by column, then one rank-ib update of
    the trailing columns).  Non-SPD input yields NaN columns (sqrt of a
    negative pivot), which the caller's info check detects."""
    b = a.shape[0]
    if b % ib != 0:
        ib = 8 if b % 8 == 0 else 1
    a = a.clone()
    idx = torch.arange(b, device=a.device)
    for j0 in range(0, b, ib):
        P = a[:, j0:j0 + ib].clone()
        for c in range(ib):
            jc = j0 + c
            d = P[jc, c]
            pj = torch.sqrt(d.real).to(a.dtype) if a.is_complex() else torch.sqrt(d)
            col = torch.where(idx > jc, P[:, c] / pj, torch.zeros((), dtype=a.dtype, device=a.device))
            P[:, c] = torch.where(idx == jc, pj, col)
            if c + 1 < ib:
                lrow = P[j0:j0 + ib, c].conj()
                lrow = torch.where(torch.arange(ib, device=a.device) > c, lrow, 0)
                P = P - torch.outer(col, lrow)
        a[:, j0:j0 + ib] = P
        Q = torch.where((idx >= j0 + ib)[:, None], P, 0)
        a = a - _dot(P, Q.mH)
    return torch.tril(a)


def _chol_panels(G: torch.Tensor, nb: int) -> torch.Tensor:
    """Blocked Cholesky of (n, n), n a multiple of nb, for n/nb <= ~4
    panels: unblocked diagonal block, explicit panel inverse + gemm,
    exact-shape trailing update."""
    n = G.shape[0]
    cols = []
    T = G
    k0 = 0
    while k0 < n:
        w = min(nb, n - k0)
        D = chol_unblocked(T[:w, :w])
        rest = n - k0 - w
        if rest > 0:
            Dinv = torch.linalg.solve_triangular(D, _eye(w, G), upper=False)
            L21 = _dot(T[w:, :w], Dinv.mH)
            T = T[w:, w:] - _dot(L21, L21.mH)
            colk = torch.cat([_zeros(k0, w, G), D, L21], dim=0)
        else:
            colk = torch.cat([_zeros(k0, w, G), D], dim=0)
        cols.append(colk)
        k0 += w
    return torch.cat(cols, dim=1)


def blocked_potrf(G: torch.Tensor, nb: int = 512, coarse_panels: int = 4) -> torch.Tensor:
    """Blocked Cholesky factor L (lower) of an SPD (n, n) tensor, n a
    multiple of 128: at most ``coarse_panels`` coarse panels of width
    NB, each diagonal block factored recursively, the panel solved as an
    explicit small triangular inverse + gemm (the MAGMA recipe)."""
    n = G.shape[0]
    if n <= 256:
        return chol_unblocked(G)
    nb = min(nb, n)
    if n % nb != 0:
        nb = 256 if n % 256 == 0 else 128
    if n % nb != 0:
        raise ValueError(f"blocked_potrf: n={n} not a multiple of 128")
    nt = n // nb
    if nt <= coarse_panels:
        return _chol_panels(G, nb)
    NB = nb * (-(-nt // coarse_panels))
    cols = []
    T = G
    k0 = 0
    while k0 < n:
        w = min(NB, n - k0)
        D = blocked_potrf(T[:w, :w], nb, coarse_panels)
        rest = n - k0 - w
        if rest > 0:
            Dinv = torch.linalg.solve_triangular(D, _eye(w, G), upper=False)
            L21 = _dot(T[w:, :w], Dinv.mH)
            T = T[w:, w:] - _dot(L21, L21.mH)
            colk = torch.cat([_zeros(k0, w, G), D, L21], dim=0)
        else:
            colk = torch.cat([_zeros(k0, w, G), D], dim=0)
        cols.append(colk)
        k0 += w
    return torch.cat(cols, dim=1)


# ---------------------------------------------------------------------------
# Recursive (divide & conquer) schedule on the halving lattice.
# ---------------------------------------------------------------------------

# auto-schedule crossover: below this the flat/blocked schedule is used
RECURSIVE_MIN_N = 2048


def split_point(n: int) -> int:
    """Top-half size of the recursion: ceil(n/2) rounded up to the best
    alignment that still leaves a nonempty trailing half."""
    h = (n + 1) // 2
    for a in (128, 64, 32, 16, 8):
        ha = -(-h // a) * a
        if ha < n:
            return ha
    return h


def _lat_height(M: int) -> int:
    """Round M up to the nearest 2^k or 3*2^(k-1) (two values per
    octave): the canonical heights of the tall LU recursion's operands,
    at most 33% zero rows; halving-lattice sizes map to themselves."""
    if M <= 0:
        return 0
    k = M.bit_length() - 1
    if M == 1 << k:
        return M
    c15 = 3 << (k - 1)  # 1.5 * 2^k
    return c15 if M <= c15 else 1 << (k + 1)


def _trsm_right_lh(L: torch.Tensor, A: torch.Tensor, nb: int) -> torch.Tensor:
    """X L^H = A with L lower triangular, by recursive 2x2 splitting:
    library solves only at <= nb diagonal blocks, the bulk in products.
    Only the lower triangle of L is read."""
    h = L.shape[0]
    if h <= nb:
        # the library returns a column-major solution; the kernels read rows
        return torch.linalg.solve_triangular(L.mH, A, upper=True, left=False).contiguous()
    s = split_point(h)
    X1 = _trsm_right_lh(L[:s, :s], A[:, :s], nb)
    X2 = _trsm_right_lh(L[s:, s:], A[:, s:] - _dot(X1, L[s:, :s].mH), nb)
    return torch.cat([X1, X2], dim=1)


def _base_chol(G: torch.Tensor, family: str) -> torch.Tensor:
    """Base case: the chol_base kernel (pallas family) or the ib-strip
    chol_unblocked (recursive family)."""
    if family == "pallas":
        return pk.chol_base(G)
    return chol_unblocked(G)


def _syrk_lower(C: torch.Tensor, A: torch.Tensor, nb: int,
                family: str = "recursive") -> torch.Tensor:
    """Lower triangle of C - A A^H by triangle recursion: only diagonal
    nb-blocks pay a full-square product.  Entries above the diagonal
    pass through (callers read the lower triangle only).  The pallas
    family runs the diagonal blocks through syrk_diag and the
    off-diagonal blocks through gemm_sub."""
    t = C.shape[0]
    if family == "pallas":
        if t <= nb:
            return pk.syrk_diag(C, A)
        s = split_point(t)
        C11 = _syrk_lower(C[:s, :s], A[:s], nb, family)
        C21 = pk.gemm_sub(C[s:, :s], A[s:], A[:s])
        C22 = _syrk_lower(C[s:, s:], A[s:], nb, family)
    else:
        if t <= nb:
            return C - _dot(A, A.mH)
        s = split_point(t)
        C11 = _syrk_lower(C[:s, :s], A[:s], nb)
        C21 = C[s:, :s] - _dot(A[s:], A[:s].mH)
        C22 = _syrk_lower(C[s:, s:], A[s:], nb)
    top = torch.cat([C11, C[:s, s:]], dim=1)
    bot = torch.cat([C21, C22], dim=1)
    return torch.cat([top, bot], dim=0)


def _chol_rec(G: torch.Tensor, nb: int, family: str = "recursive") -> torch.Tensor:
    n = G.shape[0]
    if n <= nb:
        return _base_chol(G, family)
    s = split_point(n)
    L11 = _chol_rec(G[:s, :s], nb, family)
    L21 = _trsm_right_lh(L11, G[s:, :s], nb)
    L22 = _chol_rec(_syrk_lower(G[s:, s:], L21, nb, family), nb, family)
    top = torch.cat([L11, _zeros(s, n - s, G)], dim=1)
    bot = torch.cat([L21, L22], dim=1)
    return torch.cat([top, bot], dim=0)


def chol_recursive(G: torch.Tensor, nb_switch: int = 256, lookahead: int = 1,
                   family: str = "recursive") -> torch.Tensor:
    """Divide & conquer Cholesky factor L (lower) of an SPD (n, n) tensor:
    factor the top-left half, solve the off-diagonal block, subtract the
    triangle-recursive syrk, recurse on the trailing half.
    ``lookahead`` k > 1 peels k-1 ``nb_switch``-wide panels ahead of the
    halving split at the top level.  ``family`` selects the base-case /
    update kernels: ``"recursive"`` (plain tensor code) or ``"pallas"``
    (the Hopper kernels)."""
    n = G.shape[0]
    G = G.contiguous()  # the kernels read rows with inner stride 1
    if n <= nb_switch:
        return torch.tril(_base_chol(G, family))
    cols = []
    T = G
    k0 = 0
    peel = max(int(lookahead) - 1, 0)
    while peel > 0 and (n - k0) > 2 * nb_switch:
        w = nb_switch
        D = _base_chol(T[:w, :w], family)
        L21 = _trsm_right_lh(D, T[w:, :w], nb_switch)
        T = _syrk_lower(T[w:, w:], L21, nb_switch, family)
        cols.append(torch.cat([_zeros(k0, w, G), D, L21], dim=0))
        k0 += w
        peel -= 1
    Lr = _chol_rec(T, nb_switch, family)
    if not cols:
        return torch.tril(Lr)
    Lr = torch.cat([_zeros(k0, n - k0, G), Lr], dim=0)
    return torch.tril(torch.cat(cols + [Lr], dim=1))


# ---------------------------------------------------------------------------
# FLOP accounting: pure-Python mirrors of the schedules above, equal to
# the JAX package's for the same arguments.
# ---------------------------------------------------------------------------


def _chol_unblocked_flops(b: int, ib: int = 16):
    if b % ib != 0:
        ib = 8 if b % 8 == 0 else 1
    nsteps = max(b // ib, 1)
    return nsteps * (2.0 * b * ib * b + 2.0 * b * ib * ib), {("chol_base", b)}


def _chol_base_flops(b: int, family: str = "recursive"):
    if family == "pallas":
        return 2.0 * float(b) ** 3, {("pallas_chol_base", b)}
    return _chol_unblocked_flops(b)


def _trsm_flops(t: int, h: int, nb: int):
    if h <= nb:
        return float(t) * h * h, {("trsm", h, t)}
    s = split_point(h)
    f1, u1 = _trsm_flops(t, s, nb)
    f2, u2 = _trsm_flops(t, h - s, nb)
    return f1 + f2 + 2.0 * t * s * (h - s), u1 | u2 | {("gemm", t, s, h - s)}


def _syrk_flops(t: int, h: int, nb: int, family: str = "recursive"):
    diag = "pallas_syrk" if family == "pallas" else "gemm"
    offd = "pallas_gemm" if family == "pallas" else "gemm"
    if t <= nb:
        return 2.0 * t * t * h, {(diag, t, h, t)}
    s = split_point(t)
    f1, u1 = _syrk_flops(s, h, nb, family)
    f2, u2 = _syrk_flops(t - s, h, nb, family)
    return f1 + f2 + 2.0 * (t - s) * h * s, u1 | u2 | {(offd, t - s, h, s)}


def _chol_rec_flops(n: int, nb: int, family: str = "recursive"):
    if n <= nb:
        return _chol_base_flops(n, family)
    s = split_point(n)
    f1, u1 = _chol_rec_flops(s, nb, family)
    ft, ut = _trsm_flops(n - s, s, nb)
    fs, us = _syrk_flops(n - s, s, nb, family)
    f2, u2 = _chol_rec_flops(n - s, nb, family)
    return f1 + ft + fs + f2, u1 | ut | us | u2


def _chol_panels_flops(n: int, nb: int):
    fl, units = 0.0, set()
    k0 = 0
    while k0 < n:
        w = min(nb, n - k0)
        fb, ub = _chol_unblocked_flops(w)
        fl += fb
        units |= ub
        rest = n - k0 - w
        if rest > 0:
            fl += w**3 / 2.0
            fl += 2.0 * rest * w * w
            fl += 2.0 * rest * rest * w
            units |= {("trsm", w, w), ("gemm", rest, w, w), ("gemm", rest, w, rest)}
        k0 += w
    return fl, units


def _blocked_potrf_flops(n: int, nb: int = 512, coarse_panels: int = 4):
    if n <= 256:
        return _chol_unblocked_flops(n)
    nb = min(nb, n)
    if n % nb != 0:
        nb = 256 if n % 256 == 0 else 128
    nt = n // nb
    if nt <= coarse_panels:
        return _chol_panels_flops(n, nb)
    NB = nb * (-(-nt // coarse_panels))
    fl, units = 0.0, set()
    k0 = 0
    while k0 < n:
        w = min(NB, n - k0)
        fd, ud = _blocked_potrf_flops(w, nb, coarse_panels)
        fl += fd
        units |= ud
        rest = n - k0 - w
        if rest > 0:
            fl += w**3 / 2.0 + 2.0 * rest * w * w + 2.0 * rest * rest * w
            units |= {("trsm", w, w), ("gemm", rest, w, w), ("gemm", rest, w, rest)}
        k0 += w
    return fl, units


def _chol_fori_flops(n: int, nb: int):
    if n == nb:
        return _chol_unblocked_flops(n)
    steps = n // nb
    fb, ub = _chol_unblocked_flops(nb)
    per = float(n) * nb * nb + 2.0 * n * nb * n
    return steps * (fb + per), ub | {("trsm", nb, n), ("gemm", n, nb, n)}


def chol_schedule_flops(n: int, nb: int = 512, schedule: str = "recursive",
                        nb_switch: int = 256, lookahead: int = 1) -> dict:
    """(model, exec, units) FLOP accounting for one Cholesky of size n
    under the given schedule (after the pad to a multiple of 128)."""
    npad = -(-n // 128) * 128
    model = n**3 / 3.0
    if schedule == "vendor":
        return {"model": model, "exec": float(model), "units": {("vendor_potrf", n)}}
    if schedule == "flat":
        ex, units = _blocked_potrf_flops(npad, nb)
    elif schedule == "flat_fori":
        ex, units = _chol_fori_flops(npad, nb if npad % nb == 0 else 128)
    else:
        fam = "pallas" if schedule == "pallas" else "recursive"
        ex, units = 0.0, set()
        k0, peel = 0, max(int(lookahead) - 1, 0)
        if npad <= nb_switch:
            ex, units = _chol_base_flops(npad, fam)
        else:
            while peel > 0 and (npad - k0) > 2 * nb_switch:
                w = nb_switch
                fb, ub = _chol_base_flops(w, fam)
                ft, ut = _trsm_flops(npad - k0 - w, w, nb_switch)
                fs, us = _syrk_flops(npad - k0 - w, w, nb_switch, fam)
                ex += fb + ft + fs
                units |= ub | ut | us
                k0 += w
                peel -= 1
            fr, ur = _chol_rec_flops(npad - k0, nb_switch, fam)
            ex += fr
            units |= ur
    return {"model": model, "exec": ex, "units": units}


def _launch_add(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def _syrk_launches(t: int, nb: int) -> dict:
    if t <= nb:
        return {"syrk_diag": 1}
    s = split_point(t)
    out = _launch_add(_syrk_launches(s, nb), _syrk_launches(t - s, nb))
    return _launch_add(out, {"gemm_sub": 1})


def _chol_rec_launches(n: int, nb: int) -> dict:
    if n <= nb:
        return {"chol_base": 1}
    s = split_point(n)
    out = _launch_add(_chol_rec_launches(s, nb), _syrk_launches(n - s, nb))
    return _launch_add(out, _chol_rec_launches(n - s, nb))


def chol_kernel_launches(n: int, nb_switch: int = 256, lookahead: int = 1) -> dict:
    """Hopper kernel launches of one ``pallas``-family Cholesky of size
    n (after the pad to a multiple of 128): a mirror of chol_recursive,
    as the FLOP mirrors are."""
    npad = -(-n // 128) * 128
    out = {"chol_base": 0, "syrk_diag": 0, "gemm_sub": 0}
    if npad <= nb_switch:
        return _launch_add(out, {"chol_base": 1})
    k0, peel = 0, max(int(lookahead) - 1, 0)
    while peel > 0 and (npad - k0) > 2 * nb_switch:
        out = _launch_add(out, {"chol_base": 1})
        out = _launch_add(out, _syrk_launches(npad - k0 - nb_switch, nb_switch))
        k0 += nb_switch
        peel -= 1
    return _launch_add(out, _chol_rec_launches(npad - k0, nb_switch))


def resolve_schedule(n: int, dtype, schedule: str = "auto", device="cpu") -> str:
    """Resolve an ``auto`` schedule request against the device, dtype and
    size: the library Cholesky on the CPU, the pallas (Hopper kernel)
    family at or above the crossover on a CUDA device, the flat schedule
    below it.  Explicit ``flat``/``recursive``/``pallas`` are honored on
    every device (on the CPU the kernels' plain versions run).  A dtype
    the kernels do not take on a CUDA device (complex) runs the pallas
    family's schedule as ``recursive``: library products, plain base
    cases."""
    if schedule not in ("flat", "recursive", "pallas"):
        if torch.device(device).type == "cpu":
            return "vendor"
        schedule = "pallas" if n >= RECURSIVE_MIN_N else "flat"
    if schedule == "pallas" and not pk.kernels_take(dtype, device):
        return "recursive"
    return schedule


def _vendor_cholesky(G: torch.Tensor) -> torch.Tensor:
    """Library Cholesky with the NaN-on-failure contract of the native
    schedules (``torch.linalg.cholesky`` would raise instead)."""
    L, info = torch.linalg.cholesky_ex(G)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def cholesky(G: torch.Tensor, nb: int = 512, schedule: str = "auto",
             nb_switch: int = 256, lookahead: int = 1) -> torch.Tensor:
    """Schedule-dispatched Cholesky factor L (lower) of any n: pads to a
    multiple of 128 with a unit-diagonal splice (chol of blockdiag(A, I)
    is blockdiag(L, I)) and slices the factor back out."""
    n = G.shape[0]
    route = resolve_schedule(n, G.dtype, schedule, G.device)
    if route == "vendor":
        return _vendor_cholesky(G)
    npad = -(-n // 128) * 128
    if npad != n:
        Gp = torch.nn.functional.pad(G, (0, npad - n, 0, npad - n))
        idx = torch.arange(n, npad, device=G.device)
        Gp[idx, idx] += 1
        if route in ("recursive", "pallas"):
            return chol_recursive(Gp, nb_switch, lookahead, route)[:n, :n]
        return blocked_potrf(Gp, nb)[:n, :n]
    if route in ("recursive", "pallas"):
        return chol_recursive(G, nb_switch, lookahead, route)
    return blocked_potrf(G, nb)
