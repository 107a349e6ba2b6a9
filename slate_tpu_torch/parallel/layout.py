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

    # -- per-tile queries (reference: BaseMatrix.hh:211-223, func.hh) -------

    def tileMb(self, i: int) -> int:
        """Row count of tile row i (short last tile; func.hh:39-43)."""
        return self.m - i * self.mb if (i + 1) * self.mb > self.m else self.mb

    def tileNb(self, j: int) -> int:
        return self.n - j * self.nb if (j + 1) * self.nb > self.n else self.nb

    def tileRank(self, i: int, j: int) -> Tuple[int, int]:
        """Owning (process-row, process-col) of tile (i, j)."""
        return (i % self.p, j % self.q)

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


def eye_splice(layout: TileLayout, T: torch.Tensor, scale=1.0) -> torch.Tensor:
    """Return T with ``scale`` written on the *padding* diagonal so that
    factorizations of the padded matrix stay nonsingular."""
    dev = T.device
    mask = ~layout.element_mask(dev)
    gr = torch.as_tensor(layout.global_rows_np, device=dev)[:, None, :, None]
    gc = torch.as_tensor(layout.global_cols_np, device=dev)[None, :, None, :]
    diag_pad = mask & (gr == gc)
    return torch.where(diag_pad, torch.as_tensor(scale, dtype=T.dtype, device=dev), T)
