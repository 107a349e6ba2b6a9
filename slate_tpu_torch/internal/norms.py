"""Matrix norms over tile tensors, the counterpart of the JAX package's
``internal/norms.py`` (reference: src/cuda/device_genorm.cu,
device_henorm.cu, device_synorm.cu, device_trnorm.cu; internal::norm,
src/internal/internal_genorm.cc; the norm drivers, src/norm.cc).

Each norm is a masked reduction over the (P, Q, mb, nb) tile tensor.
``genorm`` takes its per-tile statistics from the ``tile_norms`` Hopper
kernel on a CUDA device (its plain version on the CPU): the port's grids
live on one device, so the JAX package's single-device gate is always
open here.  The Frobenius norm keeps LAPACK lassq's scaling against
overflow: one ``max`` launch, a division on the device, one
``fro_sumsq`` launch, and no value goes through the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..enums import Diag, Norm, NormScope, Uplo
from ..exceptions import SlateError
from ..ops.hopper import panel_kernels as pk
from ..parallel.layout import TileLayout
from .tile_ops import diag_mask, tri_mask


def _masked(A: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, A, 0)


def _tile_stats(absA: torch.Tensor, kind: str, plain: bool = False) -> torch.Tensor:
    """Per-tile norm statistics over the (P, Q, mb, nb) tensor: the
    ``tile_norms`` kernel (its plain version on the CPU), or the plain
    version everywhere with ``plain``."""
    P, Q, mb, nb = absA.shape
    stack = absA.reshape(P * Q, mb, nb)
    out = pk.tile_norms_plain(stack, kind) if plain else pk.tile_norms(stack, kind)
    if kind in ("max", "fro_sumsq"):
        return out.reshape(P, Q)
    if kind == "one":
        return out.reshape(P, Q, nb)
    return out.reshape(P, Q, mb)


def _col_sums(absA: torch.Tensor, layout: TileLayout, plain: bool = False) -> torch.Tensor:
    """Sums of the global columns -> (n,): tile columns scattered back to
    natural order through the static permutation."""
    sums = _tile_stats(absA, "one", plain).sum(dim=0)  # (Q, nb)
    nat = sums[torch.as_tensor(layout.col_scatter, dtype=torch.long, device=sums.device)]
    return nat.reshape(-1)[: layout.n]


def _row_sums(absA: torch.Tensor, layout: TileLayout, plain: bool = False) -> torch.Tensor:
    sums = _tile_stats(absA, "inf", plain).sum(dim=1)  # (P, mb)
    nat = sums[torch.as_tensor(layout.row_scatter, dtype=torch.long, device=sums.device)]
    return nat.reshape(-1)[: layout.m]


def _scaled_fro(amax: torch.Tensor, sumsq_of_scaled) -> torch.Tensor:
    """amax sqrt(sum((|a| / amax)^2)), 0 for a zero matrix, with amax as
    the device tensor it is (lassq's scaling)."""
    safe = torch.where(amax == 0, 1, amax)
    return torch.where(amax == 0, 0, safe * torch.sqrt(sumsq_of_scaled(safe)))


def genorm(norm: Norm, T: torch.Tensor, layout: TileLayout,
           scope: NormScope = NormScope.Matrix,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """General matrix norm (reference: slate::norm -> internal::genorm;
    NormScope enums.hh:514), its per-tile statistics from the
    ``tile_norms`` kernel."""
    mask = layout.element_mask(T.device) if mask is None else mask
    absA = _masked(T.abs(), mask)
    if scope == NormScope.Columns:
        if norm != Norm.One:
            raise SlateError("column-scope norm supports Norm.One (colNorms)")
        return _col_sums(absA, layout)
    if scope == NormScope.Rows:
        if norm != Norm.Inf:
            raise SlateError("row-scope norm supports Norm.Inf")
        return _row_sums(absA, layout)

    if norm == Norm.Max:
        return _tile_stats(absA, "max").amax()
    if norm == Norm.One:
        return _col_sums(absA, layout).amax()
    if norm == Norm.Inf:
        return _row_sums(absA, layout).amax()
    if norm == Norm.Fro:
        amax = _tile_stats(absA, "max").amax()
        return _scaled_fro(amax, lambda safe: _tile_stats(absA / safe, "fro_sumsq").sum())
    raise SlateError(f"unsupported norm {norm}")


# trnorm, synorm and henorm reduce with plain tensor operations and take
# their column and row sums from tile_norms' plain version on every
# device: the JAX package routes them so (its internal/norms.py calls
# _col_sums/_row_sums there without its kernel gate), and the port keeps
# that routing, so these norms never launch tile_norms.


def trnorm(norm: Norm, T: torch.Tensor, layout: TileLayout, uplo: Uplo,
           diag: Diag = Diag.NonUnit) -> torch.Tensor:
    """Trapezoid / triangular norm (reference: internal_trnorm.cc,
    device_trnorm.cu); Diag.Unit counts the diagonal as 1."""
    dev = T.device
    absA = _masked(T.abs(), tri_mask(layout, uplo, Diag.NonUnit, device=dev))
    if diag == Diag.Unit:
        absA = torch.where(diag_mask(layout, dev), 1, absA)
    if norm == Norm.Max:
        return absA.amax()
    if norm == Norm.One:
        return _col_sums(absA, layout, plain=True).amax()
    if norm == Norm.Inf:
        return _row_sums(absA, layout, plain=True).amax()
    if norm == Norm.Fro:
        return _scaled_fro(absA.amax(), lambda safe: ((absA / safe) ** 2).sum())
    raise SlateError(f"unsupported norm {norm}")


def synorm(norm: Norm, T: torch.Tensor, layout: TileLayout, uplo: Uplo) -> torch.Tensor:
    """Symmetric norm from one stored triangle (reference:
    internal_synorm.cc, device_synorm.cu).  One == Inf by symmetry; the
    strict triangle counts twice, mirrored."""
    dev = T.device
    absS = _masked(T.abs(), tri_mask(layout, uplo, Diag.Unit, device=dev))
    absD = _masked(T.abs(), diag_mask(layout, dev))
    if norm == Norm.Max:
        return torch.maximum(absS.amax(), absD.amax())
    if norm in (Norm.One, Norm.Inf):
        # column sums of the strict triangle + its row sums (the mirror)
        # + the diagonal
        return (_col_sums(absS, layout, plain=True) + _row_sums(absS, layout, plain=True)
                + _col_sums(absD, layout, plain=True)).amax()
    if norm == Norm.Fro:
        amax = torch.maximum(absS.amax(), absD.amax())
        return _scaled_fro(
            amax, lambda safe: ((absS / safe) ** 2).sum() * 2 + ((absD / safe) ** 2).sum())
    raise SlateError(f"unsupported norm {norm}")


def henorm(norm: Norm, T: torch.Tensor, layout: TileLayout, uplo: Uplo) -> torch.Tensor:
    """Hermitian norm (reference: internal_henorm.cc, device_henorm.cu):
    synorm's structure with |.| of the complex entries."""
    return synorm(norm, T, layout, uplo)
