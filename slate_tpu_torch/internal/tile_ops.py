"""Batched tile operations over storage-order tile tensors, the
counterpart of the JAX package's ``internal/tile_ops.py`` (reference:
src/cuda/device_{geadd,gecopy,gescale,gescale_row_col,geset,transpose,
tzadd,tzcopy,tzscale,tzset}.cu; include/slate/internal/device.hh:92-282).

Every op is one elementwise tensor expression over the whole (P, Q, mb,
nb) tile tensor; uniform padding makes the batch regular.  The tz*
(trapezoid) ops take an element mask built from the layout's global
index maps.  The ops that build masks or index maps take the matrix's
``grid``: on a mesh of more than one process they build them for this
process's (mtl, ntl, mb, nb) block only.  The JAX package routes none of these to a Pallas kernel (its
``tile_geadd_pallas`` and ``tile_transpose_pallas`` have no caller), so
none of them goes to a Hopper kernel here either.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..enums import Diag, Uplo
from ..parallel.layout import TileLayout, index_maps


# -- masks ------------------------------------------------------------------


def tri_mask(layout: TileLayout, uplo: Uplo, diag: Diag = Diag.NonUnit,
             include_valid_only: bool = True, device=None, grid=None) -> torch.Tensor:
    """(P, Q, mb, nb) mask of the uplo triangle (Diag.Unit leaves the
    diagonal out), on ``device``."""
    gr, gc, valid = index_maps(layout, device, grid)
    if uplo == Uplo.Lower:
        mask = gr >= gc if diag == Diag.NonUnit else gr > gc
    elif uplo == Uplo.Upper:
        mask = gr <= gc if diag == Diag.NonUnit else gr < gc
    else:
        mask = torch.ones(torch.broadcast_shapes(gr.shape, gc.shape), dtype=torch.bool,
                          device=device)
    if include_valid_only:
        mask = mask & valid
    return mask


def diag_mask(layout: TileLayout, device=None, grid=None) -> torch.Tensor:
    gr, gc, valid = index_maps(layout, device, grid)
    return (gr == gc) & valid


# -- ge (general) ops -------------------------------------------------------


def geadd(alpha, A: torch.Tensor, beta, B: torch.Tensor) -> torch.Tensor:
    """B = alpha A + beta B (reference: device_geadd.cu; device.hh:92)."""
    return alpha * A + beta * B


def gecopy(A: torch.Tensor, dtype=None) -> torch.Tensor:
    """Copy with optional precision conversion (device_gecopy.cu)."""
    return A.to(dtype) if dtype is not None else A


def gescale(numer, denom, A: torch.Tensor) -> torch.Tensor:
    """A *= numer / denom (device_gescale.cu)."""
    return A * (numer / denom)


def gescale_row_col(layout: TileLayout, R: Optional[torch.Tensor], C: Optional[torch.Tensor],
                    A: torch.Tensor, grid=None) -> torch.Tensor:
    """A = diag(R) A diag(C) with global row and column scaling vectors
    (device_gescale_row_col.cu).  R has length >= m and C >= n; they are
    gathered through the layout's global index maps."""
    out = A
    gr, gc, _ = index_maps(layout, A.device, grid)
    if R is not None:
        out = out * R.to(A.device)[gr.long().clamp(0, R.shape[0] - 1)].to(A.dtype)
    if C is not None:
        out = out * C.to(A.device)[gc.long().clamp(0, C.shape[0] - 1)].to(A.dtype)
    return out


def geset(layout: TileLayout, offdiag_value, diag_value, A: torch.Tensor,
          grid=None) -> torch.Tensor:
    """Set the off-diagonal and the diagonal elements (device_geset.cu);
    the padding stays zero, so norms and products on padded tensors stay
    right."""
    gr, gc, valid = index_maps(layout, A.device, grid)
    out = torch.where(valid, torch.as_tensor(offdiag_value, dtype=A.dtype, device=A.device), 0)
    return torch.where((gr == gc) & valid,
                       torch.as_tensor(diag_value, dtype=A.dtype, device=A.device), out)


# -- tz (trapezoid) ops -----------------------------------------------------


def tzadd(mask, alpha, A, beta, B):
    """B = alpha A + beta B on the masked region only (device_tzadd.cu)."""
    return torch.where(mask, alpha * A + beta * B, B)


def tzcopy(mask, A, B, dtype=None):
    """B[mask] = A[mask] (device_tzcopy.cu)."""
    return torch.where(mask, A.to(B.dtype if dtype is None else dtype), B)


def tzscale(mask, numer, denom, A):
    return torch.where(mask, A * (numer / denom), A)


def tzset(layout: TileLayout, uplo: Uplo, offdiag_value, diag_value, A, grid=None):
    """Set the strict uplo triangle and the diagonal (device_tzset.cu)."""
    dev = A.device
    out = torch.where(tri_mask(layout, uplo, Diag.Unit, device=dev, grid=grid),
                      torch.as_tensor(offdiag_value, dtype=A.dtype, device=dev), A)
    return torch.where(diag_mask(layout, dev, grid),
                       torch.as_tensor(diag_value, dtype=A.dtype, device=dev), out)


# -- transpose --------------------------------------------------------------


def batch_transpose(T: torch.Tensor, conj: bool = False) -> torch.Tensor:
    """Per-tile (conj-)transpose of every tile (device_transpose.cu's
    in/out-of-place variants collapse to one tensor op)."""
    out = T.transpose(2, 3)
    if conj and T.is_complex():
        out = out.conj()
    return out
