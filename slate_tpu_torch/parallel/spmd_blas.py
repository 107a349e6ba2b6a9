"""Explicit SPMD BLAS3 over a mesh (the port of the JAX package's
``parallel/spmd_blas.py``; reference: src/gemmC.cc:76-201 impl::gemmC --
per-k listBcastMT of A's column k along process rows and B's row k
along process columns, then one batched device gemm per step;
internal_gemm.cc:355-518).

Each function is the JAX package's ``shard_map`` body, run on every rank
of the mesh on its local tile blocks (``TA`` is this rank's
(mtl, ntl, mb, nb) block; see ``grid.py``), with the collectives of
``collectives.py`` in place of the ``lax`` ones:

  * tile broadcast along a process row/col -> ``all_gather`` over the
    'q'/'p' subgroup + the owner's slot,
  * per-device batched BLAS over local tiles -> one ``torch.einsum``
    over the local tile stack (TF32 stays off: ``check_f32_precision``),
  * the JAX ``lax.fori_loop`` -> a Python loop with the same order of
    accumulation; the gathers of step k+1 are issued (``async_op``)
    before the step-k product and waited for only before product k+1,
    as the JAX carry holds step k+1's panels (:func:`_lookahead`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..aux.metrics import instrumented
from ..exceptions import DimensionError
from ..internal.precision import check_f32_precision
from .collectives import (COL_AXIS, ROW_AXIS, all_gather, all_gather_async, owner_bcast,
                          psum_scatter)
from .grid import ProcessGrid
from .layout import TileLayout


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    if dt.is_complex:
        return dt
    return torch.promote_types(dt, torch.float32)


def _einsum(spec: str, a: torch.Tensor, b: torch.Tensor, acc_t: torch.dtype) -> torch.Tensor:
    """``jnp.einsum(..., preferred_element_type=acc_t)``, full precision."""
    a, b = a.to(acc_t), b.to(acc_t)
    check_f32_precision(a, b)
    return torch.einsum(spec, a, b)


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)


def _resize_rows_3d(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x cut or zero-padded to ``rows`` in its first dimension."""
    if x.shape[0] == rows:
        return x
    if x.shape[0] > rows:
        return x[:rows]
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, rows - x.shape[0]))


def _take(panel: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """panel[idx], a natural-order tile index past the panel's end (a
    padding tile of the other operand's layout) reading zeros."""
    need = int(idx.max()) + 1 if idx.numel() else 0
    return _resize_rows_3d(panel, max(need, panel.shape[0]))[idx]


def _lookahead(steps: int, first, second=None):
    """Step k's gathered operands, k = 0 .. steps-1, with the gathers of
    step k+1 in flight while the caller computes step k.  ``first(k)``
    issues step k's gathers (async) and returns a handle; ``second(h)``
    waits for a first stage and issues the second, returning a call that
    waits for it and gives the operands.  A two-stage gather thus runs
    its first stage two steps ahead and its second one step ahead; with
    ``second`` None, ``first(k)`` returns that call itself."""
    if second is None:
        first, second = (lambda k: k), first
    if not steps:
        return
    nxt = second(first(0))
    h = first(1) if steps > 1 else None
    for k in range(steps):
        cur = nxt
        if k + 1 < steps:
            nxt = second(h)
            h = first(k + 2) if k + 2 < steps else None
        yield cur()


class _Panels:
    """The two-stage panel gathers of one storage-order tile block: A's
    tile column k (``col``) or row k in natural tile order on every rank.
    ``first`` / ``second`` are the two stages, issued async, for
    :func:`_lookahead`."""

    def __init__(self, grid: ProcessGrid, T: torch.Tensor, lay: TileLayout):
        self.grid, self.T = grid, T
        self.row_scatter = _index(lay.row_scatter, T.device)
        self.col_scatter = _index(lay.col_scatter, T.device)

    def first(self, k: int, col: bool):
        """The owner column's (row's) tiles along the process row (column)."""
        g = self.grid
        if col:
            return all_gather_async(self.T[:, k // g.q], g, COL_AXIS), k % g.q
        return all_gather_async(self.T[k // g.p], g, ROW_AXIS), k % g.p

    def second(self, h, col: bool):
        """Every rank's part of the panel, in natural tile order."""
        wait, pick = h
        full_async = all_gather_async(wait()[pick], self.grid, ROW_AXIS if col else COL_AXIS)
        scatter = self.row_scatter if col else self.col_scatter

        def panel() -> torch.Tensor:
            full = full_async()
            return full.reshape((-1,) + tuple(full.shape[2:]))[scatter]

        return panel

    def col(self, k: int) -> torch.Tensor:
        """Tile column k, natural tile-row order: (P, mb, nb)."""
        return self.second(self.first(k, True), True)()

    def row(self, k: int) -> torch.Tensor:
        """Tile row k, natural tile-column order: (Q, mb, nb)."""
        return self.second(self.first(k, False), False)()


@instrumented("spmd.summa_gemm")
def summa_gemm(grid: ProcessGrid, alpha, TA: torch.Tensor, layA: TileLayout,
               TB: torch.Tensor, layB: TileLayout, beta, TC: torch.Tensor,
               layC: TileLayout) -> torch.Tensor:
    """C = alpha A B + beta C over this rank's tile blocks (stationary C,
    SUMMA).  A: m x k tiles (mb x kb), B: k x n tiles (kb x nb), C: m x n
    (mb x nb), all on the same p x q mesh.  Returns C's new block."""
    p, q = grid.p, grid.q
    kt_total = layA.nt
    if layB.mt != kt_total:
        raise DimensionError(f"summa_gemm: A has {kt_total} tile columns, B {layB.mt} tile rows")
    acc_t = _acc_dtype(TC.dtype)

    def gather_k(kt):
        a_col = all_gather_async(TA[:, kt // q], grid, COL_AXIS)
        b_row = all_gather_async(TB[kt // p], grid, ROW_AXIS)
        # (mtl, mb, kb), (ntl, kb, nb)
        return lambda: (a_col()[kt % q], b_row()[kt % p])

    acc = torch.zeros(TC.shape, dtype=acc_t, device=TC.device)
    for a_col, b_row in _lookahead(kt_total, gather_k):
        acc = acc + _einsum("iak,jkb->ijab", a_col, b_row, acc_t)
    return (alpha * acc + beta * TC.to(acc_t)).to(TC.dtype)


def gemm_reduce_a(grid: ProcessGrid, alpha, TA: torch.Tensor, layA: TileLayout,
                  TB: torch.Tensor, layB: TileLayout, beta, TC: torch.Tensor,
                  layC: TileLayout) -> torch.Tensor:
    """Stationary-A gemm (reference: src/gemmA.cc + internal_gemmA.cc):
    each rank multiplies its local A tiles by the replicated B and the
    partial C contributions are reduce-scattered over 'q'.  Chosen by
    method auto when A is tall and C narrow (gemm.cc:12-24)."""
    p, q = grid.p, grid.q
    kt_total = layA.nt
    acc_t = _acc_dtype(TC.dtype)
    ntl, ktlB = layC.ntl, layB.mtl
    # replicate B: two gathers rebuild its storage-order tiles everywhere
    b_p = all_gather(TB, grid, ROW_AXIS)  # (p, ktlB, ntlB, kb, nb)
    b_p = b_p.reshape((p * ktlB,) + tuple(TB.shape[1:]))
    b_full = all_gather(b_p, grid, COL_AXIS)  # (q, p ktlB, ntlB, kb, nb)
    b_full = b_full.movedim(0, 1).reshape((p * ktlB, q * TB.shape[1]) + tuple(TB.shape[2:]))
    c = grid.c
    part = torch.zeros((TC.shape[0], q * ntl) + tuple(TC.shape[2:]), dtype=acc_t,
                       device=TC.device)
    for kt in range(kt_total):
        if c != kt % q:
            continue  # A's column kt lives on column kt % q; the others add 0
        a_col = TA[:, kt // q]
        b_row = b_full[(kt % p) * ktlB + kt // p]  # (q ntlB, kb, nb)
        part = part + _einsum("iak,jkb->ijab", a_col, b_row, acc_t)
    # partial over all of C's column slots (storage order), reduce-scattered
    # over 'q' so each rank keeps the sum of its own slots
    total = psum_scatter(part, grid, COL_AXIS, dim=1)
    return (alpha * total + beta * TC.to(acc_t)).to(TC.dtype)


@instrumented("spmd.herk")
def spmd_herk(grid: ProcessGrid, alpha, TA: torch.Tensor, layA: TileLayout, beta,
              TC: torch.Tensor, layC: TileLayout, conj: bool, trans: bool, alpha2=None,
              TB: torch.Tensor = None, layB: TileLayout = None,
              lower: bool = True) -> torch.Tensor:
    """Rank-k update C = alpha op(A) op(A)^(H|T) + beta C from A's stored
    tiles (reference: src/herk.cc + internal_herk.cc); with TB the
    rank-2k her2k/syr2k: alpha A B^H + alpha2 B A^H + beta C.

    No transposed copy of A is made (a resolved A^H lives on the
    transposed grid): per step k the full tile column (trans=False) or
    tile row (trans=True) of A is rebuilt on every rank by two gathers.
    Each rank accumulates only its local stored-triangle tile pairs (one
    batched product a step) and scatters them into its block once; its
    other tiles come back as beta * C."""
    p, q = grid.p, grid.q
    kt_total = layA.mt if trans else layA.nt
    mtl, ntl = layC.mtl, layC.ntl
    rank2 = TB is not None
    acc_t = _acc_dtype(TC.dtype)
    cj = (lambda x: x.conj()) if (conj and TC.is_complex()) else (lambda x: x)
    r, c = grid.position
    gi = np.arange(mtl) * p + r
    gj = np.arange(ntl) * q + c
    stored = (gi[:, None] >= gj[None, :]) if lower else (gi[:, None] <= gj[None, :])
    stored &= (gi[:, None] < layC.mt) & (gj[None, :] < layC.nt)
    I_idx, J_idx = np.nonzero(stored)  # the packed pairs, row-major
    dev = TC.device
    gi_p, gj_p = _index(gi[I_idx], dev), _index(gj[J_idx], dev)
    pa_src = _Panels(grid, TA, layA)
    pb_src = _Panels(grid, TB, layB) if rank2 else None

    srcs = (pa_src, pb_src) if rank2 else (pa_src,)

    def first(k):
        return [s.first(k, not trans) for s in srcs]

    def second(hs):
        waits = [s.second(h, not trans) for s, h in zip(srcs, hs)]
        return lambda: [w() for w in waits]

    def tile_upd(pl, pr):
        if trans:  # op(M)_{i,k} = M_{k,i}^(H|T): contraction over panel rows
            return _einsum("pca,pcb->pab", cj(pl[gi_p]), pr[gj_p], acc_t)
        return _einsum("pak,pbk->pab", pl[gi_p], cj(pr[gj_p]), acc_t)

    acc = torch.zeros((len(I_idx),) + tuple(TC.shape[2:]), dtype=acc_t, device=dev)
    for pans in _lookahead(kt_total, first, second):
        pa, pb = pans[0], pans[-1]
        if rank2:
            acc = acc + alpha * tile_upd(pa, pb) + alpha2 * tile_upd(pb, pa)
        else:
            acc = acc + alpha * tile_upd(pa, pa)
    acc_full = torch.zeros(TC.shape, dtype=acc_t, device=dev)
    acc_full[_index(I_idx, dev), _index(J_idx, dev)] = acc
    return (acc_full + beta * TC.to(acc_t)).to(TC.dtype)


@instrumented("spmd.trmm")
def spmd_trmm(grid: ProcessGrid, side_left: bool, alpha, TA: torch.Tensor, layA: TileLayout,
              lower: bool, unit_diag: bool, opa_trans: bool, opa_conj: bool,
              TB: torch.Tensor, layB: TileLayout) -> torch.Tensor:
    """Triangular multiply B <- alpha op(A) B (side_left) or alpha B op(A)
    over the mesh (reference: src/trmm.cc, src/work/work_trmm.cc): per
    step k the needed panel of op(A) is rebuilt (masked to the referenced
    triangle elementwise, Diag::Unit honored) and B's block row/column k
    is psum-broadcast from its owner -- a SUMMA over a triangular
    operand.  ``lower``/``unit_diag`` describe A's STORAGE triangle;
    ``opa_trans``/``opa_conj`` the view being multiplied."""
    p, q = grid.p, grid.q
    if not (layA.m == layA.n and layA.mb == layA.nb):
        raise DimensionError("spmd_trmm: A must be square with square tiles")
    mb, nt, n = layA.mb, layA.nt, layA.n
    acc_t = _acc_dtype(TB.dtype)
    dev = TB.device
    cjA = (lambda x: x.conj()) if (opa_conj and TB.is_complex()) else (lambda x: x)
    A = _Panels(grid, TA, layA)
    a = torch.arange(mb, device=dev)

    def tri_mask_panel(pan, k, panel_is_col):
        t = torch.arange(pan.shape[0], device=dev)
        if panel_is_col:  # pan[t] = A(t, k): rows t mb + a, cols k mb + b
            gr = t[:, None, None] * mb + a[:, None]
            gc = (k * mb + a)[None, None, :]
        else:  # pan[t] = A(k, t): rows k mb + a, cols t mb + b
            gr = (k * mb + a)[None, :, None]
            gc = t[:, None, None] * mb + a[None, None, :]
        keep = (gr >= gc) if lower else (gr <= gc)
        if unit_diag:
            keep = keep & (gr != gc)
        keep = keep & (gr < n) & (gc < n)
        out = torch.where(keep, pan, 0)
        if unit_diag:
            out = out + ((gr == gc) & (gr < n)).to(pan.dtype)
        return out

    def opA_col(k):
        """op(A)'s tile column k, natural order, triangle-masked."""
        if not opa_trans:
            return cjA(tri_mask_panel(A.col(k), k, True))
        return cjA(tri_mask_panel(A.row(k), k, False).transpose(-1, -2))

    def opA_row(k):
        """op(A)'s tile row k, natural order, triangle-masked."""
        if not opa_trans:
            return cjA(tri_mask_panel(A.row(k), k, False))
        return cjA(tri_mask_panel(A.col(k), k, True).transpose(-1, -2))

    r, c = grid.position
    gi = _index(np.arange(layB.mtl) * p + r, dev)
    gj = _index(np.arange(layB.ntl) * q + c, dev)
    acc = torch.zeros(TB.shape, dtype=acc_t, device=dev)
    for k in range(nt):
        if side_left:  # acc(i, :) += op(A)(gi, k) B(k, :)
            pan = _take(opA_col(k), gi)
            b_row = owner_bcast(TB[k // p], r == k % p, grid, ROW_AXIS)
            upd = _einsum("iab,jbc->ijac", pan, b_row, acc_t)
        else:  # acc(:, j) += B(:, k) op(A)(k, gj)
            pan = _take(opA_row(k), gj)
            b_col = owner_bcast(TB[:, k // q], c == k % q, grid, COL_AXIS)
            upd = _einsum("iab,jbc->ijac", b_col, pan, acc_t)
        acc = acc + upd
    return (alpha * acc).to(TB.dtype)


@instrumented("spmd.hemm")
def spmd_hemm(grid: ProcessGrid, side_left: bool, alpha, TA: torch.Tensor, layA: TileLayout,
              lower: bool, TB: torch.Tensor, layB: TileLayout, beta, TC: torch.Tensor,
              layC: TileLayout, hermitian: bool = True) -> torch.Tensor:
    """C = alpha A B + beta C (side_left) or alpha B A + beta C, with A
    Hermitian (symmetric with ``hermitian=False``) and ONE triangle
    stored (reference: src/hemmA.cc's broadcast/reduce DAG).  SUMMA over
    k where the op-full tile column (or row) k of A is assembled from the
    stored triangle: the stored tile column supplies the stored side of
    the diagonal and the stored tile ROW the mirror A(i, k) = A(k, i)^H
    on the other side -- two panel gathers a step, no global mirror."""
    p, q = grid.p, grid.q
    mb, nt, n = layA.mb, layA.nt, layA.n
    acc_t = _acc_dtype(TC.dtype)
    complex_t = TC.is_complex()
    dev = TC.device
    # complex SYMMETRIC operands (symm) mirror without conjugation
    cj = (lambda x: x.conj()) if (complex_t and hermitian) else (lambda x: x)
    A = _Panels(grid, TA, layA)
    a_el = torch.arange(mb, device=dev)
    t_r = torch.arange(layA.P, device=dev)
    t_c = torch.arange(layA.Q, device=dev)

    def realify_diag(panel, gr, gc):
        # zhemm's contract: the Hermitian diagonal's imaginary parts "need
        # not be set" -- drop them
        if not (complex_t and hermitian):
            return panel
        return torch.where(gr == gc, panel.real.to(panel.dtype), panel)

    def assemble(stored, mirror, gr, gc):
        from_stored = (gr >= gc) if lower else (gr <= gc)
        valid = (gr < n) & (gc < n)
        out = torch.where(valid & from_stored, stored, 0) + torch.where(
            valid & ~from_stored, mirror, 0)
        return realify_diag(out, gr, gc)

    def herm_col(k):
        """Op-full tile column k of A, natural order."""
        mirror = cj(_resize_rows_3d(A.row(k), layA.P).transpose(-1, -2))
        gr = t_r[:, None, None] * mb + a_el[:, None]
        gc = (k * mb + a_el)[None, None, :]
        return assemble(A.col(k), mirror, gr, gc)

    def herm_row(k):
        """Op-full tile row k of A, natural order."""
        mirror = cj(_resize_rows_3d(A.col(k), layA.Q).transpose(-1, -2))
        gr = (k * mb + a_el)[None, :, None]
        gc = t_c[:, None, None] * mb + a_el[None, None, :]
        return assemble(A.row(k), mirror, gr, gc)

    r, c = grid.position
    gi = _index(np.arange(layC.mtl) * p + r, dev)
    gj = _index(np.arange(layC.ntl) * q + c, dev)
    acc = torch.zeros(TC.shape, dtype=acc_t, device=dev)
    for k in range(nt):
        if side_left:
            a_col = _take(herm_col(k), gi)
            b_row = owner_bcast(TB[k // p], r == k % p, grid, ROW_AXIS)
            upd = _einsum("iab,jbc->ijac", a_col, b_row, acc_t)
        else:
            a_row = _take(herm_row(k), gj)
            b_col = owner_bcast(TB[:, k // q], c == k % q, grid, COL_AXIS)
            upd = _einsum("iab,jbc->ijac", b_col, a_row, acc_t)
        acc = acc + upd
    return (alpha * acc + beta * TC.to(acc_t)).to(TC.dtype)
