"""Band-limited stage-2 gather: tile tensor -> packed band storage, the
single-device part of the JAX package's ``parallel/band_gather.py``.

The reference moves O(n kd) data between the eigensolver stages: the
band that he2hb leaves is gathered into a band matrix, never the dense
n x n (reference: include/slate/HermitianBandMatrix.hh:310 he2hbGather,
src/heev.cc:133-151).  ``band_storage_tiles`` extracts the (kd + 1)
stored diagonals straight from the (P, Q, mb, nb) tile tensor into the
diagonal-major chase storage W[d, c] = A[c+d, c] of ``ops/bulge.py``;
``upper_band_diagonals_tiles`` extracts the (kd + 1) superdiagonals of
ge2tb's upper band for the SVD's Jordan-Wielandt stage (ge2tbGather,
include/slate/TriangularBandMatrix.hh:327).

Not ported yet: the mesh gathers (``spmd_band_storage``,
``spmd_upper_band_diagonals``; ROADMAP.md Queue 1 item 8c).
"""

from __future__ import annotations

import numpy as np
import torch

from ..aux.metrics import instrumented
from .layout import TileLayout


def _band_rowidx(nb: int) -> np.ndarray:
    """(nb+1, nb) row indices: stacked[rowidx[d, c], c] = A[c+d, c] for
    a (2nb, nb) stacked [diag; subdiag] tile pair."""
    return np.arange(nb + 1)[:, None] + np.arange(nb)[None, :]


def _assemble_w(E: torch.Tensor, layout: TileLayout, n_pad: int) -> torch.Tensor:
    """(nt, nb+1, nb) per-tile-column band -> (2nb+1, n_pad) W."""
    nb, n = layout.nb, layout.n
    Wtop = E.permute(1, 0, 2).reshape(nb + 1, layout.nt * nb)[:, :n]
    return torch.nn.functional.pad(Wtop, (0, n_pad - n, 0, nb))


@instrumented("spmd.band_storage_tiles")
def band_storage_tiles(T: torch.Tensor, layout: TileLayout, n_pad: int) -> torch.Tensor:
    """Pack the Hermitian band (kd = nb, lower storage) held in tile
    tensor T into (2nb+1, n_pad) diagonal-major storage, touching only
    the nt diagonal and nt-1 subdiagonal tiles (O(n kd) data)."""
    nb = layout.nb
    assert layout.mb == nb, "band storage requires square tiles"
    nt = layout.nt
    dev = T.device
    js = np.arange(nt)
    rs, cs = layout.row_scatter, layout.col_scatter
    idx = lambda a: torch.as_tensor(a, dtype=torch.long, device=dev)  # noqa: E731
    diag = T[idx(rs[js]), idx(cs[js])]
    sub = T[idx(rs[np.minimum(js + 1, layout.P - 1)]), idx(cs[js])]
    sub = torch.where(idx(js < nt - 1).bool()[:, None, None], sub, 0)
    stacked = torch.cat([diag, sub], dim=1)  # (nt, 2nb, nb)
    E = stacked[:, idx(_band_rowidx(nb)), torch.arange(nb, device=dev)[None, :]]
    return _assemble_w(E, layout, n_pad)


def _upper_band_extract(stacked: torch.Tensor, nb: int) -> torch.Tensor:
    """stacked: (nt, nb, 2nb) [diag | right] tile pairs.  Returns
    (nt, nb+1, nb) E with E[j, t, a] = B[j nb + a, j nb + a + t]."""
    dev = stacked.device
    colidx = torch.as_tensor(_band_rowidx(nb), dtype=torch.long, device=dev)  # t + a
    return stacked[:, torch.arange(nb, device=dev)[None, :], colidx]


@instrumented("spmd.upper_band_diagonals_tiles")
def upper_band_diagonals_tiles(T: torch.Tensor, layout: TileLayout, n: int) -> torch.Tensor:
    """The nb+1 stored superdiagonals of an upper-triangular band matrix
    (kd = nb) in tile tensor T: (nb+1, n) D with D[t, i] = B[i, i+t],
    zero where i + t >= n.  Reads only the nt diagonal tiles and their
    right neighbours (O(n kd) data)."""
    nb = layout.nb
    assert layout.mb == nb, "band storage requires square tiles"
    nt = layout.nt
    dev = T.device
    js = np.arange(nt)
    rs, cs = layout.row_scatter, layout.col_scatter
    idx = lambda a: torch.as_tensor(a, dtype=torch.long, device=dev)  # noqa: E731
    diag = T[idx(rs[js]), idx(cs[js])]
    right = T[idx(rs[js]), idx(cs[np.minimum(js + 1, layout.Q - 1)])]
    right = torch.where(idx(js < nt - 1).bool()[:, None, None], right, 0)
    stacked = torch.cat([diag, right], dim=2)  # (nt, nb, 2nb)
    E = _upper_band_extract(stacked, nb)
    Dg = E.permute(1, 0, 2).reshape(nb + 1, nt * nb)[:, :n]
    live = (torch.arange(n, device=dev)[None, :] + torch.arange(nb + 1, device=dev)[:, None]) < n
    return torch.where(live, Dg, 0)
