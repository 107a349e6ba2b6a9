"""Distributed right-looking LU over a mesh: partial pivoting and
tournament pivoting (CALU) (the port of the JAX package's
``parallel/spmd_lu.py``; reference: src/getrf.cc:85-214,
internal_getrf.cc:21-119, Tile_getrf.hh:164-452, internal_swap.cc,
src/getrf_tntpiv.cc, internal_getrf_tntpiv.cc).

The JAX package's ``shard_map`` bodies run on every rank of the mesh on
its local tile block, their ``lax.fori_loop`` a Python loop.  One step k
of ``spmd_getrf``:

1. tile column k gathered on every rank (two all_gathers) and cut to its
   active rows [k mb, m_pad) -- a slice, where the JAX package rolls them
   to the top and zeroes the wrapped rows (the same pivots: a zero row
   never beats a live one, and the first of equal magnitudes wins);
2. every rank factors the active panel with partial pivoting
   (``lu_kernels._panel_route``: the ``panel_lu`` kernel on a CUDA
   device, its plain version on the CPU), so the pivots agree without a
   broadcast;
3. the at most 2 nb rows the step moves are fetched from their owners
   (one psum over 'p') and written on theirs, in every local column;
4. the owner column writes the factored panel back; block row k of U is
   solved on its owner process row and broadcast down 'p';
5. the live trailing tiles (i > k, j > k) take one product: a slice of
   the local block, not a masked product over all of it.

``perm`` is the net forward permutation over the padded rows, the JAX
package's.  ``spmd_getrf_tntpiv`` elects each step's pivot rows by a
tournament: per process row over its own rows, then one all_gather of
the winners over 'p' and a playoff on every rank; the winners are moved
to the panel rows and the panel factored without further pivoting.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..aux.metrics import instrumented
from ..internal.precision import hdot
from ..ops import lu_kernels
from .collectives import COL_AXIS, ROW_AXIS, all_gather, owner_bcast, psum, tile_column
from .grid import ProcessGrid
from .layout import TileLayout, local_span
from .spmd_trsm import _row2d


def _fetch_rows(tl: torch.Tensor, rows: torch.Tensor, p: int, r: int, mb: int) -> torch.Tensor:
    """Global element rows ``rows`` of this rank's tile columns, (S, ntl,
    nb), zero where another process row owns the row; a psum over 'p'
    completes the fetch."""
    ti = rows // mb
    vals = tl[ti // p, :, rows % mb, :]
    return torch.where(((ti % p) == r)[:, None, None], vals, torch.zeros_like(vals))


def _write_rows(tl: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor, p: int, r: int,
                mb: int) -> None:
    """tl's rows ``rows`` <- vals where this process row owns them (a row
    listed twice carries the same values both times)."""
    ti = rows // mb
    own = (ti % p) == r
    tl[(ti // p)[own], :, (rows % mb)[own], :] = vals[own]


def _exchange(tl: torch.Tensor, dst: torch.Tensor, step: torch.Tensor, grid: ProcessGrid,
              mb: int) -> None:
    """Rows ``dst`` <- old rows step[dst] in every local column."""
    got = psum(_fetch_rows(tl, step[dst], grid.p, grid.r, mb), grid, ROW_AXIS)
    _write_rows(tl, dst, got, grid.p, grid.r, mb)


def _panel(tl: torch.Tensor, k: int, grid: ProcessGrid, row_scatter: torch.Tensor,
           mb: int) -> torch.Tensor:
    """Tile column k's active rows [k mb, m_pad) on every rank, (m_pad - k mb, nb)."""
    return tile_column(tl, k, grid)[row_scatter][k:].reshape(-1, mb)


def _finish_step(tl: torch.Tensor, k: int, lu_pan: torch.Tensor, grid: ProcessGrid,
                 layout: TileLayout) -> None:
    """Steps 4-5 of ``spmd_getrf``: the factored panel written back on its
    owner column (rows >= k), block row k of U solved on its owner
    process row and broadcast down 'p', then the live trailing tiles."""
    p, q = grid.p, grid.q
    r, c = grid.position
    mtl, ntl, mb, P = layout.mtl, layout.ntl, layout.mb, layout.P
    lu_t = lu_pan.reshape(-1, mb, mb)  # natural tiles k .. P-1
    dev = tl.device
    a, b = local_span(k, P, p, r, mtl)
    mine = lu_t[torch.arange(a, b, device=dev) * p + r - k]
    if c == k % q:
        tl[a:b, k // q] = mine
    ja, jb = local_span(k + 1, layout.Q, q, c, ntl)  # one span down a process column
    if jb == ja:
        return
    own = r == k % p
    if own:
        U = torch.linalg.solve_triangular(lu_t[0], _row2d(tl[k // p, ja:jb]), upper=False,
                                          unitriangular=True)
    else:
        U = tl.new_zeros((mb, (jb - ja) * tl.shape[3]))
    U = psum(U, grid, ROW_AXIS)
    if own:
        tl[k // p, ja:jb] = U.reshape(mb, jb - ja, tl.shape[3]).permute(1, 0, 2)
    ia = local_span(k + 1, P, p, r, mtl)[0]
    if b > ia:
        upd = hdot(mine[ia - a:].reshape(-1, mb), U)
        tl[ia:b, ja:jb] -= upd.view(b - ia, mb, jb - ja, tl.shape[3]).permute(0, 2, 1, 3)


@instrumented("spmd.getrf")
def spmd_getrf(grid: ProcessGrid, T: torch.Tensor, layout: TileLayout,
               num_steps: Optional[int] = None,
               panel_fn: Optional[Callable] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factor P A = L U over the mesh.

    T: this rank's block of the padded matrix's tiles (the padding
    diagonal spliced to 1, mb == nb).  Returns (the block of L\\U, perm),
    perm (int32, on every rank) the net forward row permutation over the
    padded rows.  ``panel_fn`` is the panel factor (default
    ``lu_kernels._panel_route``)."""
    nt = min(layout.mt, layout.nt) if num_steps is None else num_steps
    mb = layout.mb
    m_pad = layout.P * mb
    dev = T.device
    panel_fn = panel_fn or lu_kernels._panel_route(T.dtype, dev)
    row_scatter = torch.as_tensor(layout.row_scatter, dtype=torch.long, device=dev)
    g_rows = torch.arange(m_pad, device=dev)
    tl = T.clone()
    perm = torch.arange(m_pad, dtype=torch.int32, device=dev)
    for k in range(nt):
        k0 = k * mb
        # -- 1-2. the active panel, factored on every rank ------------------
        lu_pan, piv = panel_fn(_panel(tl, k, grid, row_scatter, mb))
        step = g_rows.clone()
        step[k0:] = piv.long() + k0
        # -- 3. the rows the step moves: the panel rows and their sources ---
        prow = g_rows[k0:k0 + mb]
        _exchange(tl, torch.cat([prow, step[prow]]), step, grid, mb)
        perm = perm[step]
        # -- 4-5. the panel back, the U row, the trailing update ------------
        _finish_step(tl, k, lu_pan, grid, layout)
    return tl, perm


@instrumented("spmd.getrf_tntpiv")
def spmd_getrf_tntpiv(grid: ProcessGrid, T: torch.Tensor, layout: TileLayout,
                      panel_fn: Optional[Callable] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """LU with tournament pivoting (CALU) over the mesh; returns
    (the block of L\\U, perm) as ``spmd_getrf``.  One step k:

    1. tile column k broadcast along 'q' from its owner column, so each
       process row holds its own rows of the panel (inactive rows zeroed);
    2. each process row's tournament over its rows, brackets of one tile
       (``lu_kernels.tournament_pivots``);
    3. the nb winners of every process row gathered over 'p' and a final
       playoff on every rank;
    4. winner i moves to panel row k nb + i and the displaced panel rows
       into the winners' places in order (a direct construction, as in
       the JAX package): at most 2 nb rows exchanged;
    5. the exchanged panel gathered and factored without pivoting, then
       write-back, U row and trailing update as ``spmd_getrf``.

    A bye's index (a zero row past the candidates) is clamped to the last
    candidate, as the JAX package's gather clamps it."""
    p, q = grid.p, grid.q
    r, c = grid.position
    nt = min(layout.mt, layout.nt)
    mtl, mb = layout.mtl, layout.mb
    m_pad = layout.P * mb
    dev = T.device
    panel_fn = panel_fn or lu_kernels._panel_route(T.dtype, dev)
    row_scatter = torch.as_tensor(layout.row_scatter, dtype=torch.long, device=dev)
    g_rows = torch.arange(m_pad, device=dev)
    grow = ((torch.arange(mtl, device=dev) * p + r)[:, None] * mb
            + torch.arange(mb, device=dev)).reshape(-1)
    tl = T.clone()
    perm = torch.arange(m_pad, dtype=torch.int32, device=dev)
    for k in range(nt):
        k0 = k * mb
        # -- 1. this process row's rows of the panel -------------------------
        col = owner_bcast(tl[:, k // q], c == k % q, grid, COL_AXIS).reshape(-1, mb)
        loc = torch.where((grow >= k0)[:, None], col, torch.zeros_like(col))
        # -- 2-3. the local tournament, then the playoff over 'p' ------------
        win = lu_kernels.tournament_pivots(loc, mb, mb, panel_fn).clamp(max=loc.shape[0] - 1)
        vals = all_gather(loc[win], grid, ROW_AXIS).reshape(-1, mb)
        idx = all_gather(grow[win], grid, ROW_AXIS).reshape(-1)
        fin = lu_kernels.tournament_pivots(vals, mb, mb, panel_fn).clamp(max=vals.shape[0] - 1)
        winners = idx[fin]
        # -- 4. winners to the panel rows, displaced rows to their places ---
        prow = g_rows[k0:k0 + mb]
        is_win = torch.zeros(m_pad, dtype=torch.bool, device=dev)
        is_win[winners] = True
        in_panel = (g_rows >= k0) & (g_rows < k0 + mb)
        hole, disp = is_win & ~in_panel, in_panel & ~is_win
        disp_by_rank = torch.zeros(m_pad, dtype=torch.long, device=dev)
        disp_by_rank[(torch.cumsum(disp, 0) - 1)[disp]] = g_rows[disp]
        step = g_rows.clone()
        step[prow] = winners
        step = torch.where(hole, disp_by_rank[torch.cumsum(hole, 0) - 1], step)
        _exchange(tl, torch.cat([prow, winners]), step, grid, mb)
        perm = perm[step]
        # -- 5. the exchanged panel, factored without pivoting ---------------
        lu_pan, _ = panel_fn(_panel(tl, k, grid, row_scatter, mb), pivot=False)
        _finish_step(tl, k, lu_pan, grid, layout)
    return tl, perm


def _plays(K: int) -> int:
    """Panel factors of one tournament over K brackets: the elections,
    then a play for each pair of every round (a bye makes an odd count
    even)."""
    total = K
    while K > 1:
        K = (K + 1) // 2
        total += K
    return total


def tntpiv_kernel_launches(layout: TileLayout, p: int) -> int:
    """``panel_lu`` launches of one ``spmd_getrf_tntpiv`` on each rank of a
    mesh with p process rows: a step's local tournament over its mtl
    one-tile brackets, the playoff over p, and the factor without
    pivoting (a mirror of the loop, as the schedules' mirrors are)."""
    return min(layout.mt, layout.nt) * (_plays(layout.mtl) + _plays(p) + 1)
