"""Distributed right-looking Cholesky over a mesh (the port of the JAX
package's ``parallel/spmd_chol.py``; reference: src/potrf.cc:84-209 --
per k: the diagonal tile's potrf, its broadcast down the column, the
panel's trsm, listBcastMT along rows and columns, internal::herk of the
trailing matrix).

The JAX package's ``shard_map`` body run on every rank of the mesh on its
local tile block, its ``lax.fori_loop`` a Python loop.  One step k:

1. tile column k gathered over 'q', then over 'p': the whole panel on
   every rank;
2. every rank factors the diagonal tile (redundantly, as the JAX package
   does) and solves the panel's rows below it on the right;
3. the live trailing tiles (i > k, j > k) of the local block take one
   product: a slice of the block, not a masked product over all of it;
4. the owner column writes column k of L back.

The diagonal tile's factor (:func:`tile_route`): on a CUDA device, for a
float32 / float64 tile, the hand-kernel family (``chol_kernels.cholesky``
at ``schedule="pallas"``: ``chol_base``, ``syrk_diag`` and ``gemm_sub``),
where the JAX package's comment says its native kernel runs on the chip;
the library on the CPU and for complex tiles; a schedule family the
caller names wins.  A tile that is not positive definite gives NaN, which
the driver reduces to ``info``.  Only the stored lower triangle is read;
padding tiles past the last tile row and column take no part.
"""

from __future__ import annotations

import torch

from ..aux.metrics import instrumented
from ..internal.precision import hdot
from ..ops import chol_kernels
from ..ops.hopper import panel_kernels as pk
from .collectives import tile_column
from .grid import ProcessGrid
from .layout import TileLayout, local_span


def tile_route(dtype: torch.dtype, device, schedule: str = "auto") -> str:
    """The route of the diagonal tile's factor: the schedule family the
    caller names (flat, recursive, pallas); else ``pallas`` (the hand
    kernels) for a tile the kernels take on a CUDA device and ``vendor``
    (the library) on the CPU and for complex tiles."""
    if schedule in ("flat", "recursive", "pallas"):
        return schedule
    if torch.device(device).type == "cuda" and pk.kernels_take(dtype, device):
        return "pallas"
    return "vendor"


def factor_tile(A: torch.Tensor, route: str, nb_switch: int = 256,
                lookahead: int = 1) -> torch.Tensor:
    """Lower Cholesky factor of one diagonal tile by ``route``
    (:func:`tile_route`), NaN where it is not positive definite."""
    if route == "vendor":
        return chol_kernels._vendor_cholesky(A)
    return chol_kernels.cholesky(A, A.shape[0], route, nb_switch, lookahead)


@instrumented("spmd.potrf_lower")
def spmd_potrf_lower(grid: ProcessGrid, T: torch.Tensor, layout: TileLayout,
                     schedule: str = "auto", nb_switch: int = 256,
                     lookahead: int = 1) -> torch.Tensor:
    """This rank's block of L (lower triangle; A = L L^H) from its block T
    of a padded SPD matrix's tiles (the padding diagonal spliced to 1,
    mb == nb).  ``schedule`` / ``nb_switch`` / ``lookahead`` are the
    caller's options for the diagonal tile's factor."""
    p, q = grid.p, grid.q
    r, c = grid.position
    nt, mtl, ntl, mb = layout.nt, layout.mtl, layout.ntl, layout.mb
    route = tile_route(T.dtype, T.device, schedule)
    row_scatter = torch.as_tensor(layout.row_scatter, dtype=torch.long, device=T.device)
    tl = T.clone()
    for k in range(nt):
        # -- 1. the panel, natural tile-row order ---------------------------
        pan = tile_column(tl, k, grid)[row_scatter]
        # -- 2. the diagonal tile's factor and L(i, k) = A(i, k) Lkk^-H -----
        Lkk = factor_tile(pan[k], route, nb_switch, lookahead)
        below = pan[k + 1:nt]
        if below.shape[0]:
            below = torch.linalg.solve_triangular(
                Lkk.mH, below.reshape(-1, mb), upper=True, left=False).reshape(below.shape)
        # -- 3. the live trailing tiles -------------------------------------
        a, b = local_span(k + 1, nt, p, r, mtl)
        a2, b2 = local_span(k + 1, nt, q, c, ntl)
        left = below[torch.arange(a, b, device=tl.device) * p + r - k - 1]
        if b > a and b2 > a2:
            right = below[torch.arange(a2, b2, device=tl.device) * q + c - k - 1]
            upd = hdot(left.reshape(-1, mb), right.reshape(-1, mb).mH)
            tl[a:b, a2:b2] -= upd.view(b - a, mb, b2 - a2, mb).permute(0, 2, 1, 3)
        # -- 4. column k of L on its owner column ---------------------------
        if c == k % q:
            if r == k % p:
                tl[k // p, k // q] = Lkk
            tl[a:b, k // q] = left
    return tl


def potrf_kernel_launches(layout: TileLayout, nb_switch: int = 256,
                          lookahead: int = 1) -> dict:
    """Hopper kernel launches of one ``spmd_potrf_lower`` on the ``pallas``
    tile route, on each rank: one ``chol_kernels.cholesky`` of an mb tile
    a step."""
    per = chol_kernels.chol_kernel_launches(layout.mb, nb_switch, lookahead)
    return {k: layout.nt * v for k, v in per.items()}
