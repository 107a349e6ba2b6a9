"""Shared value types (reference: include/slate/types.hh), the
counterpart of the JAX package's ``types.py``.

The reference's Pivot{tile_index, element_offset} lists (types.hh:84-117)
become one global row-permutation vector: the factorization's net row
permutation, applied with one gather.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class Pivots:
    """Row pivots as a forward permutation: (P A)[i] = A[perm[i]].

    ``perm`` is int32 (as in the JAX package) and covers the padded row
    space; rows >= m map to themselves.  The band fields (the windowed
    gbtrf's local pivot orders) stay ``None`` until the band slice."""

    perm: torch.Tensor  # (m_pad,) int32
    band_lperms: Optional[torch.Tensor] = None
    band_w: Optional[int] = None

    def apply(self, B: torch.Tensor) -> torch.Tensor:
        """B <- P B (rows permuted forward)."""
        return B[self.perm[: B.shape[0]].long()]

    def apply_inverse(self, B: torch.Tensor) -> torch.Tensor:
        perm = self.perm.long()
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.shape[0], device=perm.device)
        return B[inv[: B.shape[0]]]

    def to_ipiv(self) -> torch.Tensor:
        """The net permutation (not a LAPACK swap sequence); for shims
        where only the permutation matters."""
        return self.perm


@dataclass
class TriangularFactors:
    """Householder panel factors of QR/LQ (reference: slate.hh
    TriangularFactors = vector<Matrix>: Tlocal + Treduce).

    V lives in the factored matrix's lower (upper for LQ) triangle; ``T``
    stacks the nb x nb compact-WY block factors, one per tile panel:
    (num_panels, nb, nb)."""

    T: torch.Tensor  # (num_panels, nb, nb)
