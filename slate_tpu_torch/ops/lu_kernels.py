"""Native LU schedules with partial pivoting (reference: src/getrf.cc:85-214),
the counterpart of the JAX package's ``ops/lu_kernels.py``:

* ``panel_lu``        — unblocked partial-pivot LU of one (M, nb) panel
  (the plain version beside the ``panel_lu`` Hopper kernel).
* ``blocked_getrf``   — the single-level ``flat`` schedule: every step at
  the full padded shape, as in the JAX package (its FLOP count is the
  one ``getrf_schedule_flops`` reports).
* ``tournament_pivots`` / ``blocked_getrf_tntpiv`` — tournament (CALU)
  pivoting at the JAX package's full padded shapes; on a CUDA device its
  elections and panel factors run the Hopper ``panel_lu`` kernel.
* ``getrf_recursive`` — divide and conquer on the halving lattice with
  the canonical-height pad (``canon``), the ``act`` invariant and the
  lookahead peel; the ``pallas`` family runs its panels through the
  Hopper ``panel_lu`` kernel, the ``recursive`` family through the plain
  version.  ``pivot=False`` runs the same recursion without exchanges
  (the no-pivot LU of the random butterfly solve).
* mirrors: ``getrf_schedule_flops`` (equal to the JAX package's for the
  same arguments), ``getrf_kernel_launches``, and the tournament's
  ``tntpiv_schedule_flops`` / ``tntpiv_kernel_launches``.
* ``resolve_lu_schedule`` / ``lu_global`` — the dispatcher; ``vendor`` is
  ``torch.linalg.lu_factor``.

Large solves and products go to ``torch.linalg.solve_triangular`` /
``torch.matmul`` (TF32 off), as the JAX package leaves them to XLA.
Tensors stay on the device they came on.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..internal.precision import hdot as _dot
from .chol_kernels import RECURSIVE_MIN_N, _eye, _lat_height, _trsm_flops, split_point
from .hopper import panel_kernels as pk

#: the plain panel factor (op for op the JAX package's ``panel_lu``)
panel_lu = pk.panel_lu_plain


def blocked_getrf(Gp: torch.Tensor, nb: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked right-looking LU with partial pivoting of a padded array.

    Gp: (Mp, Np), Mp >= Np, both multiples of nb, padding diagonal
    spliced to 1.  Returns (LU, perm): LU = (L\\U) of Gp[perm].  Every
    step runs at the full padded shape (panel rolled to the top, masked
    trsm row and trailing product), as the JAX package's single compiled
    loop does."""
    Mp, Np = Gp.shape
    G = Gp.clone()
    rows = torch.arange(Mp, device=G.device)
    cols = torch.arange(Np, device=G.device)
    perm = torch.arange(Mp, dtype=torch.int32, device=G.device)
    zero = torch.zeros((), dtype=G.dtype, device=G.device)
    eye = _eye(nb, G)
    for k in range(min(Mp, Np) // nb):
        k0, k1 = k * nb, (k + 1) * nb
        colr = torch.roll(G[:, k0:k1], -k0, dims=0)
        colr = torch.where((rows < Mp - k0)[:, None], colr, zero)
        lu_pan, piv = panel_lu(colr)
        act = rows - k0
        mapped = piv.long()[act.clamp(0, Mp - 1)] + k0
        step = torch.where(act >= 0, mapped, rows)
        G, perm = G[step], perm[step]
        col_new = torch.where((rows >= k0)[:, None], torch.roll(lu_pan, k0, dims=0),
                              G[:, k0:k1])
        G[:, k0:k1] = col_new
        Lkk = torch.tril(lu_pan[:nb], -1) + eye
        row = G[k0:k1]
        rs = torch.linalg.solve_triangular(Lkk, row, upper=False, unitriangular=True)
        row_new = torch.where((cols >= k1)[None, :], rs, row)
        G[k0:k1] = row_new
        Lpan = torch.where((rows >= k1)[:, None], col_new, zero)
        Urow = torch.where((cols >= k1)[None, :], row_new, zero)
        G = G - _dot(Lpan, Urow)
    return G, perm


def _panel_route(dtype: torch.dtype, device) -> Callable:
    """The panel factor of the tournament: the Hopper ``panel_lu`` kernel
    on a CUDA device for a dtype it takes (its plain version on the
    CPU), ``panel_lu_plain`` for the others (complex on the card), the
    route every resolver takes.  Both give bitwise-equal results."""
    return pk.panel_lu if pk.kernels_take(dtype, device) else panel_lu


def tournament_pivots(panel: torch.Tensor, nb: int, chunk: int,
                      panel_fn: Callable) -> torch.Tensor:
    """Tournament (CALU) pivot selection on an (M, nb) panel (reference:
    src/getrf_tntpiv.cc, internal_getrf_tntpiv.cc): every ``chunk`` rows
    elect nb candidate rows with a partial-pivot LU, and the winners play
    up a binary tree, one panel factor a bracket.  An odd bracket count
    gets a zero-row bye with the index M.

    Returns the nb winning row indices (into panel, M for a bye's row),
    in pivot order, int64 on the panel's device.  ``panel_fn`` is the
    panel factor, which ``blocked_getrf_tntpiv`` chooses."""
    M, nbp = panel.shape
    assert nbp == nb and chunk >= nb and M % chunk == 0

    def play(ch, ix):  # the nb rows a bracket elects, in pivot order
        win = panel_fn(ch)[1][:nb].long()
        return ch[win], ix[win]

    cands = panel.reshape(M // chunk, chunk, nb)
    idxs = torch.arange(M, device=panel.device).reshape(M // chunk, chunk)
    while True:  # the elections, then each round's plays, brackets in order
        won = [play(cands[b], idxs[b]) for b in range(cands.shape[0])]
        cands, idxs = torch.stack([c for c, _ in won]), torch.stack([i for _, i in won])
        if len(won) == 1:
            return idxs[0]
        if len(won) % 2 == 1:  # odd: the last bracket gets a zero-row bye
            cands = torch.cat([cands, cands.new_zeros((1, nb, nb))])
            idxs = torch.cat([idxs, torch.full_like(idxs[:1], M)])
        cands, idxs = cands.reshape(-1, 2 * nb, nb), idxs.reshape(-1, 2 * nb)


def blocked_getrf_tntpiv(Gp: torch.Tensor, nb: int, chunk: int = 0,
                         panel_fn: Optional[Callable] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked LU with tournament pivoting (reference: getrf_tntpiv.cc,
    MethodLU.CALU), the JAX package's loop at its full padded shapes:
    rows padded to whole chunks (``chunk`` = 4 nb by default), each
    step's panel rolled to the top, its pivot rows elected by
    ``tournament_pivots``, moved to the top in order (the other rows keep
    their order behind them), and the panel factored without further
    exchanges; then the masked U row and trailing update of
    ``blocked_getrf``.  Returns (LU, perm) over Gp's rows: LU = (L\\U) of
    Gp[perm].  ``panel_fn`` is the panel factor of the elections and the
    factor (default: ``_panel_route``)."""
    Mp, Np = Gp.shape
    dev = Gp.device
    panel_fn = panel_fn or _panel_route(Gp.dtype, dev)
    chunk = chunk or max(4 * nb, nb)
    Mc = -(-Mp // chunk) * chunk
    G = torch.nn.functional.pad(Gp, (0, 0, 0, Mc - Mp)).contiguous()
    rows = torch.arange(Mc, device=dev)
    cols = torch.arange(Np, device=dev)
    perm = torch.arange(Mc, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=G.dtype, device=dev)
    eye = _eye(nb, G)
    for k in range(min(Mp, Np) // nb):
        k0, k1 = k * nb, (k + 1) * nb
        active = (rows < Mp - k0)[:, None]
        colr = torch.where(active, torch.roll(G[:, k0:k1], -k0, dims=0), zero)
        win = tournament_pivots(colr, nb, chunk, panel_fn)  # active frame
        # winners to the top in order, the other rows behind them in
        # theirs; a bye's index (Mc) names no row
        hit = win < Mc
        is_win = torch.zeros(Mc, dtype=torch.int64, device=dev)
        is_win[win[hit]] = 1
        win_pos = torch.zeros(Mc, dtype=torch.int64, device=dev)
        win_pos[win[hit]] = torch.arange(nb, device=dev)[hit]
        rest_rank = torch.cumsum(1 - is_win, 0) - 1
        key = torch.where(is_win == 1, win_pos, nb + rest_rank)
        step_act = torch.argsort(key, stable=True)
        mapped = torch.where(rows - k0 >= 0, step_act[(rows - k0).clamp(0, Mc - 1)] + k0, rows)
        step = torch.where(mapped < Mc, mapped, mapped - Mc)
        G, perm = G[step], perm[step]
        colr2 = torch.where(active, torch.roll(G[:, k0:k1], -k0, dims=0), zero)
        lu_pan, _ = panel_fn(colr2, pivot=False)
        col_new = torch.where((rows >= k0)[:, None], torch.roll(lu_pan, k0, dims=0),
                              G[:, k0:k1])
        G[:, k0:k1] = col_new
        Lkk = torch.tril(lu_pan[:nb], -1) + eye
        row = G[k0:k1]
        rs = torch.linalg.solve_triangular(Lkk, row, upper=False, unitriangular=True)
        row_new = torch.where((cols >= k1)[None, :], rs, row)
        G[k0:k1] = row_new
        Lpan = torch.where((rows >= k1)[:, None], col_new, zero)
        Urow = torch.where((cols >= k1)[None, :], row_new, zero)
        G = G - _dot(Lpan, Urow)
    return G[:Mp], perm[:Mp]


def tntpiv_kernel_launches(m: int, n: int, nb: int, chunk: int = 0) -> int:
    """``panel_lu`` calls of one ``blocked_getrf_tntpiv`` of a padded
    (m, n) tensor: a step's elections (one a chunk), its plays (one a
    bracket a round, byes included) and its factor without pivoting."""
    chunk = chunk or max(4 * nb, nb)
    K = -(-m // chunk)
    calls = K + 1
    while K > 1:
        K = (K + 1) // 2
        calls += K
    return (min(m, n) // nb) * calls


def tntpiv_schedule_flops(m: int, n: int, nb: int, chunk: int = 0,
                          m_true: Optional[int] = None, n_true: Optional[int] = None) -> dict:
    """(model, exec, units) FLOP accounting for one
    ``blocked_getrf_tntpiv`` of a padded (m, n) tensor, in
    ``getrf_schedule_flops``' terms: each step's elections and plays,
    its panel factor without pivoting, the U-row solve and the trailing
    update, all at the full padded shapes the loop runs."""
    mt, nt_ = (m_true or m), (n_true or n)
    model = float(nt_) * nt_ * (mt - nt_ / 3.0)
    chunk = chunk or max(4 * nb, nb)
    Mc = -(-m // chunk) * chunk
    K, plays = Mc // chunk, 0
    while K > 1:
        K = (K + 1) // 2
        plays += K
    panel = lambda M: 2.0 * M * nb * nb  # noqa: E731  (one rank-1 a column)
    per_step = ((Mc // chunk) * panel(chunk) + plays * panel(2 * nb) + panel(Mc)
                + float(nb) * nb * n + 2.0 * Mc * nb * n)
    units = {("lu_panel", chunk, nb), ("lu_panel", Mc, nb), ("trsm", nb, n), ("gemm", Mc, nb, n)}
    if plays:
        units.add(("lu_panel", 2 * nb, nb))
    return {"model": model, "exec": (min(m, n) // nb) * per_step, "units": units}


# ---------------------------------------------------------------------------
# Recursive (divide & conquer) schedule on the halving lattice
# ---------------------------------------------------------------------------


def _trsm_left_unit(L: torch.Tensor, B: torch.Tensor, nb: int) -> torch.Tensor:
    """L X = B with L unit-lower (only its strict lower triangle is
    read), by recursive 2x2 splitting: library solves at <= nb diagonal
    blocks, products for the rest."""
    h = L.shape[0]
    if h <= nb:
        return torch.linalg.solve_triangular(L, B, upper=False, unitriangular=True)
    s = split_point(h)
    B1 = _trsm_left_unit(L[:s, :s], B[:s], nb)
    B2 = _trsm_left_unit(L[s:, s:], B[s:] - _dot(L[s:, :s], B1), nb)
    return torch.cat([B1, B2], dim=0)


def getrf_recursive(G: torch.Tensor, nb_switch: int = 256, lookahead: int = 1,
                    family: str = "recursive", pivot: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recursive blocked LU of an (m, n) tensor, m >= n, partial pivoting
    unless ``pivot=False``.  Returns (LU, perm): LU = (L\\U) of G[perm].

    Factor the left n1 = split_point(n) columns recursively, permute the
    right half by their pivots, solve U12 with the recursive unit-lower
    trsm, one exact-shape Schur product, recurse on the trailing block
    and compose the two permutations: the pivot order is LAPACK's.  The
    trailing block's height snaps to the canonical ``_lat_height`` of
    its true rows (``act``): rows at or past ``act`` are exact zeros and
    never pivot.  ``lookahead`` k > 1 peels k-1 ``nb_switch``-wide panels
    ahead of the split at the top level.  ``family``: ``"pallas"`` runs
    the panels through the Hopper kernel, ``"recursive"`` through the
    plain version (identical arithmetic, identical pivot order)."""
    m, n = G.shape
    if m < n:
        raise ValueError(f"getrf_recursive requires m >= n, got {(m, n)}")
    G = G.contiguous()  # the panel kernel reads rows with inner stride 1
    _panel_fn = pk.panel_lu if family == "pallas" else panel_lu

    def _panel(X, act=None):
        return _panel_fn(X, pivot=pivot, act=act)

    def _rows(X, p):
        return X[p.long()] if pivot else X

    def canon(X, act):
        """Snap X's height to ``_lat_height(act)`` (truncate zero rows or
        zero-pad); returns (X', restore), restore mapping the child's
        (LU, perm) back to X's frame."""
        M = X.shape[0]
        Mc = _lat_height(act)
        if Mc == M:
            return X, lambda LU, p: (LU, p)
        if Mc < M:
            def restore(LU, p):
                LU = torch.cat([LU, LU.new_zeros((M - Mc, LU.shape[1]))])
                tail = torch.arange(Mc, M, dtype=p.dtype, device=p.device)
                return LU, torch.cat([p, tail])

            return X[:Mc], restore

        def restore(LU, p):  # the child's pad rows are fixed points
            return LU[:M], p[:M]

        return torch.nn.functional.pad(X, (0, 0, 0, Mc - M)), restore

    def rec(G, act):
        # invariant: rows >= act of G are exact zeros (never pivotable)
        M, n = G.shape
        if n <= nb_switch:
            return _panel(G, None if act >= M else act)
        s = split_point(n)
        LU1, p1 = rec(G[:, :s], act)
        R = _rows(G[:, s:], p1)
        U12 = _trsm_left_unit(LU1[:s, :s], R[:s], nb_switch)
        S2, restore = canon(torch.cat([LU1[s:, :s], R[s:]], dim=1), act - s)
        S = S2[:, s:] - _dot(S2[:, :s], U12)
        LU2, p2 = restore(*rec(S, act - s))
        top = torch.cat([LU1[:s], U12], dim=1)
        bot = torch.cat([_rows(LU1[s:], p2), LU2], dim=1)
        perm = torch.cat([p1[:s], _rows(p1[s:], p2)])
        return torch.cat([top, bot], dim=0), perm

    if n <= nb_switch:
        return _panel(G)
    peel = max(int(lookahead) - 1, 0)
    frames = []  # (top row block, L below, step perm), outermost first
    T, act = G, m
    while peel > 0 and T.shape[1] > 2 * nb_switch:
        w = nb_switch
        LU1, p1 = _panel(T[:, :w], None if act >= T.shape[0] else act)
        R = _rows(T[:, w:], p1)
        U12 = _trsm_left_unit(LU1[:w, :w], R[:w], nb_switch)
        S = R[w:] - _dot(LU1[w:, :w], U12)
        frames.append((torch.cat([LU1[:w], U12], dim=1), LU1[w:], p1))
        T, act = S, act - w
        peel -= 1
    bot, p = rec(T, act)
    # stitch the peeled frames back around the trailing factor,
    # composing permutations innermost-out
    for top, Lw, p1 in reversed(frames):
        w = top.shape[0]
        bot = torch.cat([top, torch.cat([_rows(Lw, p), bot], dim=1)], dim=0)
        p = torch.cat([p1[:w], _rows(p1[w:], p)])
    return bot, p


def getrf_kernel_launches(n: int, nb_switch: int = 256, lookahead: int = 1) -> int:
    """``panel_lu`` calls of one ``getrf_recursive`` of n columns (any
    height; n after getrf's pad to whole tiles): a mirror of the
    recursion, one call a leaf and one a peeled panel."""
    def rec(n: int) -> int:
        if n <= nb_switch:
            return 1
        s = split_point(n)
        return rec(s) + rec(n - s)

    if n <= nb_switch:
        return 1
    k0, peel, count = 0, max(int(lookahead) - 1, 0), 0
    while peel > 0 and (n - k0) > 2 * nb_switch:
        count += 1
        k0 += nb_switch
        peel -= 1
    return count + rec(n - k0)


# ---------------------------------------------------------------------------
# FLOP accounting: a pure-Python mirror, equal to the JAX package's for
# the same arguments.
# ---------------------------------------------------------------------------


def getrf_schedule_flops(m: int, n: int, nb: int = 512, schedule: str = "recursive",
                         nb_switch: int = 256, lookahead: int = 1,
                         m_true: Optional[int] = None, n_true: Optional[int] = None) -> dict:
    """(model, exec, units) FLOP accounting for one pivoted LU of (m, n),
    m >= n, mirroring the schedule (masked full-shape steps counted at
    full shape).  model = n^2 (m - n/3) of the true problem (m_true,
    n_true) when given, so padded shapes report their waste."""
    mt, nt_ = (m_true or m), (n_true or n)
    model = float(nt_) * nt_ * (mt - nt_ / 3.0)
    panel_unit = "pallas_lu_panel" if schedule == "pallas" else "lu_panel"

    def panel_flops(M, b):
        # one full-height rank-1 on the whole (M, b) panel a column
        return 2.0 * M * b * min(M, b), {(panel_unit, M, b)}

    if schedule == "vendor":
        return {"model": model, "exec": float(n) * n * (m - n / 3.0),
                "units": {("vendor_lu", m, n)}}
    if schedule == "flat":
        kt = max(min(m, n) // max(nb, 1), 1)
        fp, up = panel_flops(m, nb)
        per_step = fp + float(n) * nb * nb + 2.0 * m * n * nb
        return {"model": model, "exec": kt * per_step,
                "units": up | {("trsm", nb, n), ("gemm", m, nb, n)}}
    if schedule == "flat_fast":
        nbf = _lu_fast_nb(n) or max(nb, 1)
        nt = max(n // nbf, 1)
        NB = nbf * (-(-nt // 4))
        ex, units = 0.0, set()
        k0 = 0
        while k0 < n:
            W = min(NB, n - k0)
            mk = m - k0
            ex += 2.0 * mk * nbf * W + 2.0 * nbf * W * W + 2.0 * mk * W * W
            units |= {("lu_block", mk, W)}
            rest = n - k0 - W
            if rest > 0:
                ex += W**3 / 2.0 + 2.0 * W * W * rest
                ex += 2.0 * (mk - W) * W * rest
                units |= {("trsm", W, W), ("gemm", W, W, rest), ("gemm", mk - W, W, rest)}
            k0 += W
        return {"model": model, "exec": ex, "units": units}

    def rec(M, act, n):
        # M: physical (canonical) height, act: true rows (canon's mirror)
        if n <= nb_switch:
            return panel_flops(M, n)
        s = split_point(n)
        f1, u1 = rec(M, act, s)
        ft, ut = _trsm_flops(n - s, s, nb_switch)
        Mc = _lat_height(act - s)
        fg = 2.0 * Mc * s * (n - s)
        f2, u2 = rec(Mc, act - s, n - s)
        return f1 + ft + fg + f2, u1 | ut | u2 | {("gemm", Mc, s, n - s)}

    ex, units = 0.0, set()
    k0, peel = 0, max(int(lookahead) - 1, 0)
    while peel > 0 and (n - k0) > 2 * nb_switch:
        w = nb_switch
        fp, up = panel_flops(m - k0, w)
        ft, ut = _trsm_flops(n - k0 - w, w, nb_switch)
        fg = 2.0 * (m - k0 - w) * w * (n - k0 - w)
        ex += fp + ft + fg
        units |= up | ut | {("gemm", m - k0 - w, w, n - k0 - w)}
        k0 += w
        peel -= 1
    fr, ur = rec(m - k0, m - k0, n - k0)
    return {"model": model, "exec": ex + fr, "units": units | ur}


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def lu_supported(dtype) -> bool:
    """Whether the library LU takes this dtype: ``torch.linalg.lu_factor``
    takes every floating and complex dtype on the CPU and on CUDA."""
    return True


def _lu_fast_nb(n: int) -> int:
    """Block size of the three-level lu_fast schedule, 0 when the shape
    does not admit it — shared by dispatch and accounting."""
    for nbf in (512, 256, 128):
        if n % nbf == 0:
            return nbf
    return 0


def resolve_lu_schedule(m: int, n: int, dtype, schedule: str = "auto", device="cpu") -> str:
    """The route ``lu_global`` takes for this shape, dtype and device —
    shared with getrf's FLOP accounting.  Explicit ``recursive`` /
    ``pallas`` are honored for m >= n on every device (on the CPU the
    pallas family runs the kernel's plain version); ``flat`` is the
    three-level ``lu_fast`` schedule for large divisible squares
    (``flat_fast``), ``blocked_getrf`` otherwise.  ``auto``: the pallas
    (Hopper kernel) family for squares at or above the crossover on a
    CUDA device, the library LU otherwise.  A dtype the kernels do not
    take on a CUDA device (complex) runs the pallas family's schedule as
    ``recursive`` (the plain panel)."""
    if schedule in ("recursive", "pallas") and m >= n:
        route = schedule
    elif schedule in ("flat", "recursive", "pallas"):
        if m == n and n >= 2048 and _lu_fast_nb(n):
            return "flat_fast"
        return "flat"
    elif torch.device(device).type != "cpu" and m == n and n >= RECURSIVE_MIN_N:
        route = "pallas"
    else:
        return "vendor" if lu_supported(dtype) else "flat"
    if route == "pallas" and not pk.kernels_take(dtype, device):
        return "recursive"
    return route


def ipiv_to_perm(ipiv: torch.Tensor, m: int) -> torch.Tensor:
    """LAPACK's ipiv (1-based row interchanges, applied in order) as the
    forward permutation over m rows, int32 on ipiv's device."""
    perm = np.arange(m, dtype=np.int32)
    for i, p in enumerate(ipiv.cpu().numpy().astype(np.int64) - 1):
        perm[i], perm[p] = perm[p], perm[i]
    return torch.from_numpy(perm).to(ipiv.device)


def lu_global(Gp: torch.Tensor, nb: int, schedule: str = "auto", nb_switch: int = 256,
              lookahead: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Schedule-dispatched LU of the padded global tensor.  Returns
    (LU, perm), perm (int32) over Gp's padded rows."""
    route = resolve_lu_schedule(*Gp.shape, Gp.dtype, schedule, Gp.device)
    if route in ("recursive", "pallas"):
        return getrf_recursive(Gp, nb_switch, lookahead, route)
    if route == "vendor":
        LU, ipiv, _ = torch.linalg.lu_factor_ex(Gp)
        return LU.contiguous(), ipiv_to_perm(ipiv, Gp.shape[0])
    if route == "flat_fast":
        from .lu_fast import blocked_getrf_fast

        return blocked_getrf_fast(Gp, _lu_fast_nb(Gp.shape[1]))
    return blocked_getrf(Gp, nb)
