"""Distributed triangular solves and row permutation over a mesh (the
port of the JAX package's ``parallel/spmd_trsm.py``; reference:
src/trsm.cc, src/work/work_trsm.cc:106-140 -- per k: the diagonal tile
broadcast down its column, internal::trsm of block row k, the solved
row broadcast, internal::gemm of the trailing rows -- and
internal_swap.cc's pivot row exchanges).

Each function is the JAX package's ``shard_map`` body run on every rank
of the mesh on its local tile blocks, its ``lax.fori_loop`` a Python
loop over the step k.  One step of the left (row) pipeline:

1. the tiles op(T)(i, k) of this rank's rows and the diagonal tile: T's
   tile column k gathered over 'q' (NoTrans), or T's tile row k gathered
   over 'q' and broadcast down 'p' (Trans / ConjTrans);
2. block row k of B solved on its owner process row (a library
   triangular solve, as the JAX package's ``lax.linalg.triangular_solve``)
   and broadcast down 'p';
3. the rows still to solve updated by one product: a slice of the local
   block (i > k forward, i < k backward), not a masked product over all
   of it.

Forward (lower op(T)) solves run k = 0 .. nt-1, backward ones
k = nt-1 .. 0.  Only T's stored triangle is read (an LU-packed array
serves its L and its U solve).  Padding tile rows past T's last tile
take no part (the JAX package updates them with values never read).
``spmd_trsm_right`` is the column-pipeline dual, broadcasting along 'q'.
"""

from __future__ import annotations

import torch

from ..aux.metrics import instrumented
from ..exceptions import slate_assert
from ..internal.precision import hdot
from .collectives import COL_AXIS, ROW_AXIS, all_gather, owner_bcast, psum
from .grid import ProcessGrid
from .layout import TileLayout, local_span


def _row2d(tiles: torch.Tensor) -> torch.Tensor:
    """A block row's tiles (J, mb, nb) as one (mb, J nb) matrix."""
    return tiles.permute(1, 0, 2).reshape(tiles.shape[1], -1)


def _row_tiles(x: torch.Tensor, nb: int) -> torch.Tensor:
    """The inverse of :func:`_row2d`."""
    return x.reshape(x.shape[0], -1, nb).permute(1, 0, 2)


def _tri_solve(Tkk: torch.Tensor, B: torch.Tensor, lower: bool, unit: bool,
               left: bool) -> torch.Tensor:
    """op(Tkk) X = B (left) or X op(Tkk) = B, reading op(Tkk)'s triangle."""
    return torch.linalg.solve_triangular(Tkk.resolve_conj(), B, upper=not lower, left=left,
                                         unitriangular=unit)


def _checks(grid: ProcessGrid, layT: TileLayout, layB: TileLayout, nb_b: int, nt_b: int):
    slate_assert(layT.m == layT.n and layT.mb == layT.nb, "trsm T must be square tiles")
    slate_assert(layT.mb == nb_b, "T/B tile mismatch")
    slate_assert((layT.p, layT.q) == (layB.p, layB.q) == (grid.p, grid.q), "grid mismatch")
    slate_assert(nt_b == layT.nt, "T/B tile-count mismatch")


@instrumented("spmd.trsm_left")
def spmd_trsm_left(grid: ProcessGrid, TT: torch.Tensor, layT: TileLayout, TB: torch.Tensor,
                   layB: TileLayout, *, lower: bool, trans: bool, conj: bool, unit_diag: bool,
                   alpha=1.0) -> torch.Tensor:
    """Solve op(T) X = alpha B; returns X's block.

    TT: this rank's block of the square triangular matrix's tiles
    (mb == nb; the padding diagonal spliced to 1, ``layout.eye_splice``).
    ``lower`` names the *storage* triangle; ``trans`` / ``conj`` the op of
    the view solved."""
    _checks(grid, layT, layB, layB.mb, layB.mt)
    p, q = grid.p, grid.q
    r, c = grid.position
    nt, ntlT, mtlB, mb = layT.nt, layT.ntl, layB.mtl, layT.mb
    eff_lower = lower != trans  # the triangle of op(T)
    forward = eff_lower
    cj = (lambda x: x.conj()) if (conj and TT.is_complex()) else (lambda x: x)
    tb = TB * alpha if alpha != 1.0 else TB.clone()
    for kk in range(nt):
        k = kk if forward else nt - 1 - kk
        lo, hi = (k + 1, nt) if forward else (0, k)
        a, b = local_span(lo, hi, p, r, mtlB)  # the rows still to solve
        gi = torch.arange(a, b, device=tb.device) * p + r
        # -- 1. op(T)(gi, k) and the diagonal tile on every rank -------------
        if not trans:
            col = all_gather(TT[:, k // q], grid, COL_AXIS)[k % q]  # T(rows of r, k)
            Tkk = owner_bcast(col[k // p], r == k % p, grid, ROW_AXIS)
            left = col[a:b]
        else:
            row = all_gather(TT[k // p], grid, COL_AXIS).reshape(-1, mb, mb)
            row = owner_bcast(row, r == k % p, grid, ROW_AXIS)  # T(k, :), storage order
            left = row[(gi % q) * ntlT + gi // q].mT
            Tkk = row[(k % q) * ntlT + k // q].mT
        left, Tkk = cj(left), cj(Tkk)
        # -- 2. block row k, solved on its owner process row ----------------
        own = r == k % p
        if own:
            X = _tri_solve(Tkk, _row2d(tb[k // p]), eff_lower, unit_diag, left=True)
        else:
            X = tb.new_zeros((mb, tb.shape[1] * tb.shape[3]))
        X = psum(X, grid, ROW_AXIS)
        if own:
            tb[k // p] = _row_tiles(X, tb.shape[3])
        # -- 3. the live rows ------------------------------------------------
        if b > a:
            upd = hdot(left.reshape(-1, mb), X)
            tb[a:b] -= upd.view(b - a, mb, tb.shape[1], tb.shape[3]).permute(0, 2, 1, 3)
    return tb


@instrumented("spmd.permute_rows")
def spmd_permute_rows(grid: ProcessGrid, TB: torch.Tensor, layB: TileLayout,
                      perm: torch.Tensor) -> torch.Tensor:
    """Apply a global row permutation, new row i = old row perm[i]
    (reference: internal_swap.cc:115-370 permuteRows).  ``perm`` indexes
    the padded element rows (layB.P mb long, as ``spmd_lu`` returns it).
    Each process row gathers its process column's blocks along 'p' and
    picks the source of each of its rows (the JAX package fetches every
    row with one masked psum over 'p'; the rows that arrive are the
    same)."""
    p, mtl, mb = layB.p, layB.mtl, layB.mb
    r = grid.r
    ntl, nb = TB.shape[1], TB.shape[3]
    full = all_gather(TB, grid, ROW_AXIS).reshape(p * mtl, ntl, mb, nb)
    gi = torch.arange(mtl, device=TB.device) * p + r
    dst = (gi[:, None] * mb + torch.arange(mb, device=TB.device)).reshape(-1)
    src = perm.to(TB.device).long()[dst]
    t = src // mb
    vals = full[(t % p) * mtl + t // p, :, src % mb, :]  # (mtl mb, ntl, nb)
    return vals.reshape(mtl, mb, ntl, nb).permute(0, 2, 1, 3).contiguous()


@instrumented("spmd.trsm_right")
def spmd_trsm_right(grid: ProcessGrid, TT: torch.Tensor, layT: TileLayout, TB: torch.Tensor,
                    layB: TileLayout, *, lower: bool, trans: bool, conj: bool, unit_diag: bool,
                    alpha=1.0) -> torch.Tensor:
    """Solve X op(T) = alpha B; returns X's block (reference: trsmB's
    right-side pipeline, src/work/work_trsm.cc): per step the solved
    block *column* is broadcast along 'q' and the columns still to solve
    are updated."""
    _checks(grid, layT, layB, layB.nb, layB.nt)
    p, q = grid.p, grid.q
    r, c = grid.position
    nt, mtlT, ntlB, mb = layT.nt, layT.mtl, layB.ntl, layT.mb
    eff_lower = lower != trans
    forward = not eff_lower  # X U = B solves column 0 first
    cj = (lambda x: x.conj()) if (conj and TT.is_complex()) else (lambda x: x)
    tb = TB * alpha if alpha != 1.0 else TB.clone()
    mtlB, mbB = tb.shape[0], tb.shape[2]
    for kk in range(nt):
        k = kk if forward else nt - 1 - kk
        lo, hi = (k + 1, nt) if forward else (0, k)
        a, b = local_span(lo, hi, q, c, ntlB)  # the columns still to solve
        gj = torch.arange(a, b, device=tb.device) * q + c
        # -- 1. op(T)(k, gj) and the diagonal tile on every rank -------------
        if not trans:
            row = owner_bcast(TT[k // p], r == k % p, grid, ROW_AXIS)  # T(k, cols of c)
            Tkk = owner_bcast(row[k // q], c == k % q, grid, COL_AXIS)
            right = row[a:b]
        else:
            col = owner_bcast(TT[:, k // q], c == k % q, grid, COL_AXIS)
            col = all_gather(col, grid, ROW_AXIS).reshape(-1, mb, mb)  # T(:, k), storage order
            right = col[(gj % p) * mtlT + gj // p].mT
            Tkk = col[(k % p) * mtlT + k // p].mT
        right, Tkk = cj(right), cj(Tkk)
        # -- 2. block column k, solved on its owner process column ----------
        own = c == k % q
        if own:
            X = _tri_solve(Tkk, tb[:, k // q].reshape(-1, mb), eff_lower, unit_diag, left=False)
        else:
            X = tb.new_zeros((mtlB * mbB, mb))
        X = psum(X, grid, COL_AXIS)
        if own:
            tb[:, k // q] = X.reshape(mtlB, mbB, mb)
        # -- 3. the live columns ---------------------------------------------
        if b > a:
            upd = hdot(X, _row2d(right.resolve_conj()))
            tb[:, a:b] -= upd.view(mtlB, mbB, b - a, mb).permute(0, 2, 1, 3)
    return tb
