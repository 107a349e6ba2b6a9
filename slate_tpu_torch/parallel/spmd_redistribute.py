"""Distribution-to-distribution tile re-send over a mesh (the port of the
JAX package's ``parallel/spmd_redistribute.py``; reference:
src/redistribute.cc -- per-tile MPI sends between two layouts).

Two masked-psum phases bound the traffic, run on every rank on its
local block:

1. row phase: every destination element row is fetched from its owner
   process row with one psum over 'p' (columns stay source-distributed
   -- O(n^2 / q) per process);
2. column phase: dual over 'q' (rows now destination-distributed --
   O(n^2 / p) per process).

Both layouts must live on the same mesh (p, q); ``drivers/aux.py``'s
``redistribute`` takes the recorded gather route otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..aux.metrics import instrumented
from ..exceptions import DimensionError
from .collectives import COL_AXIS, ROW_AXIS, psum
from .grid import ProcessGrid
from .layout import TileLayout


def _long(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)


@instrumented("spmd.redistribute")
def spmd_redistribute(grid: ProcessGrid, TA: torch.Tensor, layA: TileLayout,
                      layB: TileLayout, out_dtype=None) -> torch.Tensor:
    """This rank's block of B's (P_B, Q_B, mbB, nbB) tiles holding A's
    elements, from its block of A's."""
    p, q = grid.p, grid.q
    if not ((layA.p, layA.q) == (p, q) == (layB.p, layB.q) and
            (layA.m, layA.n) == (layB.m, layB.n)):
        raise DimensionError(f"spmd_redistribute: layouts {layA} and {layB} on a {p}x{q} grid")
    m, n = layA.m, layA.n
    mbA, nbA = layA.mb, layA.nb
    mbB, nbB = layB.mb, layB.nb
    ntlA = layA.ntl
    mtlB, ntlB = layB.mtl, layB.ntl
    out_dtype = out_dtype or TA.dtype
    dev = TA.device
    r, c = grid.position

    # static element maps: destination padded element row -> source
    # (local tile-row slot, in-tile offset, owner process row)
    dst_rows = np.minimum(layB.global_rows_np.reshape(-1), m - 1)  # (P_B mbB,)
    src_ti = np.minimum(dst_rows // mbA, layA.mt - 1)
    dst_cols = np.minimum(layB.global_cols_np.reshape(-1), n - 1)
    src_tj = np.minimum(dst_cols // nbA, layA.nt - 1)

    # -- phase 1: rows -> B distribution (psum over 'p') ---------------
    # vals[d] = A's element row for padded destination row d, over this
    # rank's local source columns
    vals = TA[_long(src_ti // p, dev), :, _long(dst_rows % mbA, dev), :]
    own = torch.as_tensor(src_ti % p == r, device=dev)[:, None, None]
    vals = psum(torch.where(own, vals, 0), grid, ROW_AXIS)  # (P_B mbB, ntlA, nbA)
    # keep this process row's destination tile rows
    slots = r * mtlB + np.arange(mtlB)  # storage slots of B's local tile rows
    mine = vals.reshape(layB.P, mbB, ntlA, nbA)[_long(slots, dev)]

    # -- phase 2: columns -> B distribution (psum over 'q') ------------
    flat = mine.reshape(mtlB * mbB, ntlA * nbA)
    cols = flat[:, _long((src_tj // q) * nbA + dst_cols % nbA, dev)].T  # (Q_B nbB, mtlB mbB)
    cown = torch.as_tensor(src_tj % q == c, device=dev)[:, None]
    cvals = psum(torch.where(cown, cols, 0), grid, COL_AXIS)
    cslots = c * ntlB + np.arange(ntlB)
    minec = cvals.reshape(layB.Q, nbB, mtlB * mbB)[_long(cslots, dev)]  # (ntlB, nbB, mtlB mbB)
    out = minec.permute(2, 0, 1).reshape(mtlB, mbB, ntlB, nbB).permute(0, 2, 1, 3)
    # zero the padding elements of B's layout
    rm = torch.as_tensor(layB.row_mask_np[slots], device=dev)
    cm = torch.as_tensor(layB.col_mask_np[cslots], device=dev)
    mask = rm[:, None, :, None] & cm[None, :, None, :]
    return torch.where(mask, out, 0).to(out_dtype)
