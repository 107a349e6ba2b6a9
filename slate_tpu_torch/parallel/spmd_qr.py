"""Distributed Householder QR over a mesh (the port of the JAX package's
``parallel/spmd_qr.py``; reference: src/geqrf.cc:26-230 -- the local
panel geqrf, the ttqrt tree, the broadcast of V and T and the unmqr /
ttmqr trailing update).

As in the JAX package the panel is gathered and factored on every rank
(no CAQR tree), and the trailing update is the compact-WY rank-nb update
C <- (I - V T^H V^H) C with one psum over 'p'.  The ``shard_map`` body
runs on every rank of the mesh on its local tile block, the
``lax.fori_loop`` a Python loop.  One step k:

1. tile column k gathered (two all_gathers) and cut to its active rows
   [k mb, m_pad) -- a slice, where the JAX package rolls them to the top
   and zeroes the wrapped rows (QR of [A; 0] has the same R, taus and
   reflectors, with zeros below);
2. every rank factors the active panel (``householder.geqrf``: the
   library QR for a 512-wide panel) and builds its T: the ``larft``
   kernel on a CUDA device for a dtype it takes, its plain version on
   the CPU and for complex panels;
3. the owner column writes the factored column back (rows >= k);
4. W = V^H C over the local rows (i >= k), psum over 'p', then
   C -= V (T^H W) on the live local tiles (i >= k, j > k).

The T factors come back replicated, (kt, nb, nb).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..aux.metrics import instrumented
from ..exceptions import slate_assert
from ..internal.precision import hdot
from ..ops.hopper import panel_kernels as pk
from ..ops.householder import geqrf as _geqrf_panel, larft as _larft_plain, materialize_v
from .collectives import ROW_AXIS, psum, tile_column
from .grid import ProcessGrid
from .layout import TileLayout, local_span


def larft_route(dtype: torch.dtype, device):
    """The T assembly of a panel: the ``larft`` kernel (its plain version
    on the CPU), or the plain ``larft`` for a dtype the kernel does not
    take on a CUDA device (complex)."""
    return pk.larft if pk.kernels_take(dtype, device) else _larft_plain


@instrumented("spmd.geqrf")
def spmd_geqrf(grid: ProcessGrid, T: torch.Tensor,
               layout: TileLayout) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factor A = Q R over the mesh from this rank's block T of the
    padded matrix's tiles (mb == nb).  Returns (the block of the factored
    tiles: R on and above the diagonal, V below with an implicit unit
    diagonal; Tstack (kt, nb, nb), every panel's compact-WY T, the same
    on every rank)."""
    p, q = grid.p, grid.q
    r, c = grid.position
    mb = layout.mb
    slate_assert(mb == layout.nb, "geqrf requires square tiles")
    kt = min(layout.mt, layout.nt)
    mtl, ntl, P = layout.mtl, layout.ntl, layout.P
    dev = T.device
    larft = larft_route(T.dtype, dev)
    row_scatter = torch.as_tensor(layout.row_scatter, dtype=torch.long, device=dev)
    tl = T.clone()
    Tstack = T.new_zeros((kt, mb, mb))
    for k in range(kt):
        # -- 1-2. the active panel, factored on every rank, and its T --------
        pact = tile_column(tl, k, grid)[row_scatter][k:].reshape(-1, mb)
        vr, taus = _geqrf_panel(pact)
        V = materialize_v(vr)
        Tk = larft(V, taus)
        Tstack[k] = Tk
        # -- 3. the factored column back on its owner column (rows >= k) -----
        a, b = local_span(k, P, p, r, mtl)
        rows = torch.arange(a, b, device=dev) * p + r - k  # natural tiles of pact
        if c == k % q:
            tl[a:b, k // q] = vr.reshape(-1, mb, mb)[rows]
        # -- 4. C <- (I - V T^H V^H) C on the live local tiles ---------------
        ja, jb = local_span(k + 1, layout.Q, q, c, ntl)  # one span down a process column
        if jb == ja:
            continue
        Vloc = V.reshape(-1, mb, mb)[rows].reshape(-1, mb)
        C = tl[a:b, ja:jb].permute(0, 2, 1, 3).reshape(-1, (jb - ja) * mb)
        W = psum(hdot(Vloc.mH, C), grid, ROW_AXIS)  # (mb, J nb)
        upd = hdot(Vloc, hdot(Tk.mH, W))
        tl[a:b, ja:jb] -= upd.view(b - a, mb, jb - ja, mb).permute(0, 2, 1, 3)
    return tl, Tstack
