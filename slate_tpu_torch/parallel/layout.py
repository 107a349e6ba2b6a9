"""Tile layout: 2D block-cyclic distribution as owner-major storage
(reference: include/slate/internal/MatrixStorage.hh:151, func.hh:100-265,
BaseMatrix.hh:211-223 tileRank/tileDevice).

A matrix is ONE tensor of tiles with shape

    (P, Q, mb, nb),   P = p * mtl,  Q = q * ntl

stored in *owner-major* (cyclic-permuted) order: global tile (i, j) lives
at storage slot (srow(i), scol(j)) with

    srow(i) = (i % p) * mtl + i // p        (mtl = ceil(mt / p))
    scol(j) = (j % q) * ntl + j // q        (ntl = ceil(nt / q))

so process (r, c) of a p x q grid owns one contiguous block of slots.
The index math is the JAX package's, element for element; only the
tensors it gathers are PyTorch's.  Edge tiles are padded to uniform
(mb, nb) with zeros; factorization drivers splice an identity into the
padded diagonal (``eye_splice``) so the padded system stays nonsingular.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import numpy as np
import torch


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class TileLayout:
    """Static index math for an m x n matrix tiled mb x nb on a p x q grid."""

    m: int
    n: int
    mb: int
    nb: int
    p: int = 1
    q: int = 1

    # -- tile counts --------------------------------------------------------

    @property
    def mt(self) -> int:
        return ceil_div(self.m, self.mb)

    @property
    def nt(self) -> int:
        return ceil_div(self.n, self.nb)

    @property
    def mtl(self) -> int:
        """Local (per process-row) padded tile-row count."""
        return ceil_div(self.mt, self.p)

    @property
    def ntl(self) -> int:
        return ceil_div(self.nt, self.q)

    @property
    def P(self) -> int:
        """Padded global tile-row count (= p * mtl)."""
        return self.p * self.mtl

    @property
    def Q(self) -> int:
        return self.q * self.ntl

    @property
    def storage_shape(self) -> Tuple[int, int, int, int]:
        return (self.P, self.Q, self.mb, self.nb)

    @property
    def local_shape(self) -> Tuple[int, int, int, int]:
        """One process's block of the storage on a p x q mesh."""
        return (self.mtl, self.ntl, self.mb, self.nb)

    # -- per-tile queries (reference: BaseMatrix.hh:211-223, func.hh) -------

    def tileMb(self, i: int) -> int:
        """Row count of tile row i (short last tile; func.hh:39-43)."""
        return self.m - i * self.mb if (i + 1) * self.mb > self.m else self.mb

    def tileNb(self, j: int) -> int:
        return self.n - j * self.nb if (j + 1) * self.nb > self.n else self.nb

    def tileRank(self, i: int, j: int) -> Tuple[int, int]:
        """Owning (process-row, process-col) of tile (i, j)."""
        return (i % self.p, j % self.q)

    def tileIsLocal(self, i: int, j: int, r: int, c: int) -> bool:
        return self.tileRank(i, j) == (r, c)

    # -- storage permutation -------------------------------------------------

    def srow(self, i):
        """Storage row slot of global tile-row i."""
        return (i % self.p) * self.mtl + i // self.p

    def scol(self, j):
        return (j % self.q) * self.ntl + j // self.q

    def lrow(self, s):
        """Inverse of srow: global tile-row stored at slot s."""
        return (s % self.mtl) * self.p + s // self.mtl

    def lcol(self, s):
        return (s % self.ntl) * self.q + s // self.ntl

    @cached_property
    def row_gather(self) -> np.ndarray:
        """index array g with storage[s] = natural[g[s]] (natural padded to P)."""
        return np.array([self.lrow(s) for s in range(self.P)], dtype=np.int32)

    @cached_property
    def col_gather(self) -> np.ndarray:
        return np.array([self.lcol(s) for s in range(self.Q)], dtype=np.int32)

    @cached_property
    def row_scatter(self) -> np.ndarray:
        """index array h with natural[i] = storage[h[i]]."""
        return np.array([self.srow(i) for i in range(self.P)], dtype=np.int32)

    @cached_property
    def col_scatter(self) -> np.ndarray:
        return np.array([self.scol(j) for j in range(self.Q)], dtype=np.int32)

    # -- masks for ragged edges ---------------------------------------------

    @cached_property
    def row_mask_np(self) -> np.ndarray:
        """(P, mb) bool: valid rows of each storage tile-row slot."""
        mask = np.zeros((self.P, self.mb), dtype=bool)
        for s in range(self.P):
            i = self.lrow(s)
            if i < self.mt:
                mask[s, : self.tileMb(i)] = True
        return mask

    @cached_property
    def col_mask_np(self) -> np.ndarray:
        mask = np.zeros((self.Q, self.nb), dtype=bool)
        for s in range(self.Q):
            j = self.lcol(s)
            if j < self.nt:
                mask[s, : self.tileNb(j)] = True
        return mask

    def element_mask(self, device=None) -> torch.Tensor:
        """(P, Q, mb, nb) bool mask of valid (non-padding) elements."""
        rm = torch.as_tensor(self.row_mask_np, device=device)[:, None, :, None]
        cm = torch.as_tensor(self.col_mask_np, device=device)[None, :, None, :]
        return rm & cm

    # -- global element index maps ------------------------------------------

    @cached_property
    def global_rows_np(self) -> np.ndarray:
        """(P, mb) int32: global row index of each storage element row
        (padding slots point past m; clip before use)."""
        out = np.zeros((self.P, self.mb), dtype=np.int32)
        for s in range(self.P):
            out[s] = self.lrow(s) * self.mb + np.arange(self.mb)
        return out

    @cached_property
    def global_cols_np(self) -> np.ndarray:
        out = np.zeros((self.Q, self.nb), dtype=np.int32)
        for s in range(self.Q):
            out[s] = self.lcol(s) * self.nb + np.arange(self.nb)
        return out

    @cached_property
    def trivial_perm(self) -> bool:
        """True when storage order == natural order (p == q == 1), letting
        pack/unpack skip the index gathers entirely."""
        return bool(
            np.array_equal(self.row_gather, np.arange(self.P))
            and np.array_equal(self.col_gather, np.arange(self.Q))
        )

    # -- derived layouts -----------------------------------------------------

    def transposed(self) -> "TileLayout":
        """Layout of A^T: dims, tiles and grid swap."""
        return TileLayout(self.n, self.m, self.nb, self.mb, self.q, self.p)

    def with_grid(self, p: int, q: int) -> "TileLayout":
        return TileLayout(self.m, self.n, self.mb, self.nb, p, q)


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.long, device=device)


def permute_tiles(T: torch.Tensor, rows: np.ndarray, cols: np.ndarray) -> torch.Tensor:
    """Gather tile rows and columns of a (P, Q, mb, nb) tile tensor."""
    return T[_index(rows, T.device)][:, _index(cols, T.device)]


# ---------------------------------------------------------------------------
# Conversions: global 2D tensor <-> storage-order tile tensor.
# ---------------------------------------------------------------------------


def tiles_from_global(A: torch.Tensor, layout: TileLayout) -> torch.Tensor:
    """Pack a (m, n) tensor into storage-order tiles (P, Q, mb, nb) on
    A's device (reference analogue: Matrix::fromLAPACK).  Padding
    elements are zero."""
    m, n = layout.m, layout.n
    if tuple(A.shape) != (m, n):
        raise ValueError(f"expected {(m, n)}, got {tuple(A.shape)}")
    Pm, Qn = layout.P * layout.mb, layout.Q * layout.nb
    A = torch.nn.functional.pad(A, (0, Qn - n, 0, Pm - m))
    T = A.reshape(layout.P, layout.mb, layout.Q, layout.nb).permute(0, 2, 1, 3)
    if layout.trivial_perm:
        return T.contiguous()
    return permute_tiles(T, layout.row_gather, layout.col_gather)


def tiles_to_global(T: torch.Tensor, layout: TileLayout) -> torch.Tensor:
    """Unpack storage-order tiles back to the (m, n) global tensor."""
    if tuple(T.shape) != layout.storage_shape:
        raise ValueError(f"{tuple(T.shape)} != {layout.storage_shape}")
    Tn = T if layout.trivial_perm else permute_tiles(
        T, layout.row_scatter, layout.col_scatter
    )
    A = Tn.permute(0, 2, 1, 3).reshape(layout.P * layout.mb, layout.Q * layout.nb)
    return A[: layout.m, : layout.n]


def zeros_tiles(layout: TileLayout, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros(layout.storage_shape, dtype=dtype, device=device)


def local_block(T: torch.Tensor, layout: TileLayout, r: int, c: int) -> torch.Tensor:
    """Process (r, c)'s block of the storage-order tiles (or of anything
    indexed like them in its first two dimensions): tile rows
    [r mtl, (r+1) mtl), tile columns [c ntl, (c+1) ntl) -- the
    block-cyclic tiles {i : i % p == r} x {j : j % q == c}."""
    mtl, ntl = layout.mtl, layout.ntl
    return T[r * mtl:(r + 1) * mtl, c * ntl:(c + 1) * ntl]


def local_tiles(T: torch.Tensor, layout: TileLayout, grid) -> torch.Tensor:
    """Whole storage-order tiles T as a matrix on ``grid`` holds them:
    this process's block on a mesh of more than one process, T elsewhere
    (``grid`` None included)."""
    if grid is None or not grid.is_distributed:
        return T
    r, c = grid.position
    return local_block(T, layout, r, c).contiguous()


def local_tiles_from_global(A: torch.Tensor, layout: TileLayout, grid) -> torch.Tensor:
    """The (m, n) global A as a matrix on ``grid`` holds its tiles
    (:func:`tiles_from_global`, then :func:`local_tiles`)."""
    return local_tiles(tiles_from_global(A, layout), layout, grid)


def index_maps(layout: TileLayout, device=None, grid=None):
    """The global row index (S, 1, mb, 1) and column index (1, S', 1, nb)
    of every element of the tiles held, and their valid (non-padding)
    mask: the whole storage, or on a mesh of more than one process this
    process's block (what :func:`local_tiles` keeps)."""
    rows, cols = layout.global_rows_np, layout.global_cols_np
    rmask, cmask = layout.row_mask_np, layout.col_mask_np
    if grid is not None and grid.is_distributed:
        r, c = grid.position
        rs = slice(r * layout.mtl, (r + 1) * layout.mtl)
        cs = slice(c * layout.ntl, (c + 1) * layout.ntl)
        rows, rmask, cols, cmask = rows[rs], rmask[rs], cols[cs], cmask[cs]
    gr = torch.as_tensor(rows, device=device)[:, None, :, None]
    gc = torch.as_tensor(cols, device=device)[None, :, None, :]
    valid = (torch.as_tensor(rmask, device=device)[:, None, :, None]
             & torch.as_tensor(cmask, device=device)[None, :, None, :])
    return gr, gc, valid


def from_blocks(blocks) -> torch.Tensor:
    """The storage-order tiles from every process's block, ``blocks[r][c]``
    (the inverse of :func:`local_block` over the grid)."""
    return torch.cat([torch.cat(list(row), dim=1) for row in blocks], dim=0)


def eye_splice(layout: TileLayout, T: torch.Tensor, scale=1.0, grid=None) -> torch.Tensor:
    """Return T with ``scale`` written on the *padding* diagonal so that
    factorizations of the padded matrix stay nonsingular.  T is the whole
    storage, or on a mesh of more than one process ``grid``'s block of it
    (what :func:`local_tiles` keeps)."""
    gr, gc, valid = index_maps(layout, T.device, grid)
    diag_pad = ~valid & (gr == gc)
    return torch.where(diag_pad, torch.as_tensor(scale, dtype=T.dtype, device=T.device), T)


def local_span(lo: int, hi: int, n_axis: int, pos: int, nloc: int) -> Tuple[int, int]:
    """The local slots [a, b) of a process at ``pos`` along an axis of
    ``n_axis`` processes whose global tile index l * n_axis + pos lies in
    [lo, hi) (a contiguous run: the index grows with the slot)."""
    a = max(0, -(-(lo - pos) // n_axis))
    b = min(nloc, max(0, -(-(hi - pos) // n_axis)))
    return a, max(a, b)
