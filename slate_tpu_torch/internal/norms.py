"""Matrix norms over tile tensors, the counterpart of the JAX package's
``internal/norms.py`` (reference: src/cuda/device_genorm.cu,
device_henorm.cu, device_synorm.cu, device_trnorm.cu; internal::norm,
src/internal/internal_genorm.cc; the norm drivers, src/norm.cc).

Each norm is a masked reduction over the (P, Q, mb, nb) tile tensor.
``genorm`` takes its per-tile statistics from the ``tile_norms`` Hopper
kernel on a CUDA device (its plain version on the CPU): the port's grids
live on one device, so the JAX package's single-device gate is always
open here.  It hands the kernel the stored, signed tiles (complex ones
as |T|) with the layout's valid row and column counts, which say all
that the JAX package's padding mask says: no ``abs``, ``where`` or mask
pass runs before the kernel, and the padding is never read.  The
Frobenius norm keeps LAPACK lassq's guard against overflow and
underflow: one ``max_sumsq`` launch gives the max and the unscaled sum
of squares, and a ``fro_sumsq`` launch divided by the max runs in full
only where the unscaled sum could overflow or underflow (otherwise it
is told to skip); no value goes through the host.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..enums import Diag, Norm, NormScope, Uplo
from ..exceptions import SlateError
from ..ops.hopper import panel_kernels as pk
from ..parallel import collectives as coll
from ..parallel.layout import TileLayout
from .tile_ops import diag_mask, tri_mask


def _masked(A: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, A, 0)


@functools.lru_cache(maxsize=64)
def _layout_tensors(layout: TileLayout, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The layout's valid rows of each storage tile-row slot (P,) and
    valid columns of each tile-column slot (Q,), int32, and its row and
    column scatter indices, on ``device``: made once per layout and
    device."""
    return (torch.as_tensor(layout.row_mask_np.sum(1), dtype=torch.int32, device=device),
            torch.as_tensor(layout.col_mask_np.sum(1), dtype=torch.int32, device=device),
            torch.as_tensor(layout.row_scatter, dtype=torch.long, device=device),
            torch.as_tensor(layout.col_scatter, dtype=torch.long, device=device))


def _tile_stats(A: torch.Tensor, kind: str, layout: Optional[TileLayout] = None,
                plain: bool = False, **fro) -> torch.Tensor:
    """Per-tile norm statistics of |A| over the (P, Q, mb, nb) tensor, a
    row (or a row of values) a tile in storage order, counting only the
    layout's valid elements when ``layout`` is given (every element
    otherwise): the ``tile_norms`` kernel (its plain version on the CPU),
    or the plain version everywhere with ``plain``.  ``fro`` passes
    fro_sumsq's ``scale`` and ``skip``."""
    P, Q, mb, nb = A.shape
    counts = {}
    if layout is not None:
        counts["rows"], counts["cols"] = _layout_tensors(layout, A.device)[:2]
    fn = pk.tile_norms_plain if plain else pk.tile_norms
    return fn(A.reshape(P * Q, mb, nb), kind, **counts, **fro)


def _tile_col_sums(A: torch.Tensor, layout: Optional[TileLayout], plain: bool) -> torch.Tensor:
    """Sums down the columns of each tile column slot -> (Q, nb)."""
    P, Q, _, nb = A.shape
    return _tile_stats(A, "one", layout, plain).view(P, Q, nb).sum(dim=0)


def _tile_row_sums(A: torch.Tensor, layout: Optional[TileLayout], plain: bool) -> torch.Tensor:
    """Sums along the rows of each tile row slot -> (P, mb)."""
    P, Q, mb, _ = A.shape
    return _tile_stats(A, "inf", layout, plain).view(P, Q, mb).sum(dim=1)


def _col_sums(A: torch.Tensor, layout: TileLayout, plain: bool = False,
              counted: bool = False) -> torch.Tensor:
    """Sums of |A| down the global columns -> (n,): tile columns
    scattered back to natural order through the static permutation.
    ``counted``: A holds padding, which the layout's counts leave out."""
    sums = _tile_col_sums(A, layout if counted else None, plain)
    nat = sums[_layout_tensors(layout, sums.device)[3]]
    return nat.reshape(-1)[: layout.n]


def _row_sums(A: torch.Tensor, layout: TileLayout, plain: bool = False,
              counted: bool = False) -> torch.Tensor:
    sums = _tile_row_sums(A, layout if counted else None, plain)
    nat = sums[_layout_tensors(layout, sums.device)[2]]
    return nat.reshape(-1)[: layout.m]


def _scaled_fro(amax: torch.Tensor, sumsq_of_scaled) -> torch.Tensor:
    """amax sqrt(sum((|a| / amax)^2)), 0 for a zero matrix, with amax as
    the device tensor it is (lassq's scaling)."""
    safe = torch.where(amax == 0, 1, amax)
    return torch.where(amax == 0, 0, safe * torch.sqrt(sumsq_of_scaled(safe)))


def _fro(A: torch.Tensor, layout: Optional[TileLayout], n_elems: int) -> torch.Tensor:
    """Frobenius norm from two launches: ``max_sumsq`` (amax and the
    unscaled sum s0), then ``fro_sumsq`` of |a| / safe (safe = amax, or
    1 for a zero matrix), skipped on the device where sqrt(s0) is safe:
    ok = sqrt(tiny) / eps <= amax <= sqrt(huge / n_elems), so no square
    of an element >= eps amax underflows and the sum cannot overflow
    (NaN and Inf fall outside).  The result, sqrt(ok ? s0 : s1) (ok ? 1
    : safe), is the JAX package's safe sqrt(s1) outside that range (0
    for a zero matrix, NaN for NaN or Inf)."""
    amax, s0 = _tile_stats(A, "max_sumsq", layout).unbind(1)
    amax, s0 = amax.amax(), s0.sum()
    fi = torch.finfo(A.dtype)
    ok = amax.clamp(fi.tiny ** 0.5 / fi.eps, (fi.max / max(n_elems, 1)) ** 0.5) == amax
    safe = torch.where(amax == 0, 1, amax)
    s1 = _tile_stats(A, "fro_sumsq", layout, scale=safe, skip=ok).sum()
    return torch.sqrt(torch.where(ok, s0, s1)) * torch.where(ok, 1, safe)


def genorm(norm: Norm, T: torch.Tensor, layout: TileLayout,
           scope: NormScope = NormScope.Matrix,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """General matrix norm (reference: slate::norm -> internal::genorm;
    NormScope enums.hh:514), its per-tile statistics from the
    ``tile_norms`` kernel.  The kernel reads the stored tiles (|T| for a
    complex T) and the layout's counts; a caller's ``mask`` takes the
    JAX package's route instead: |T| masked, then the kernel without
    counts.  One and Inf take the max over the tile slots' sums as they
    lie (the padding's sums are 0), not in natural order."""
    if mask is None:
        A, lay = (T.abs() if T.is_complex() else T), layout
        if A.stride(-1) != 1:  # a resolved transposed view: the kernel reads rows
            A = A.contiguous()
    else:
        A, lay = _masked(T.abs(), mask), None
    if scope == NormScope.Columns:
        if norm != Norm.One:
            raise SlateError("column-scope norm supports Norm.One (colNorms)")
        return _col_sums(A, layout, counted=lay is not None)
    if scope == NormScope.Rows:
        if norm != Norm.Inf:
            raise SlateError("row-scope norm supports Norm.Inf")
        return _row_sums(A, layout, counted=lay is not None)

    if norm == Norm.Max:
        return _tile_stats(A, "max", lay).amax()
    if norm == Norm.One:
        return _tile_col_sums(A, lay, False).amax()
    if norm == Norm.Inf:
        return _tile_row_sums(A, lay, False).amax()
    if norm == Norm.Fro:
        return _fro(A, lay, layout.m * layout.n)
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


# -- on a mesh ---------------------------------------------------------------
# Each rank holds its (mtl, ntl, mb, nb) block of the tiles.  The JAX
# package leaves the reduction across processes to GSPMD, which turns its
# masked reductions into ICI psum / pmax; here that reduction is written
# out: per-tile statistics of the local block (tile_norms for a general
# matrix, with this rank's slice of the layout's counts), then a pmax for
# Max, a psum of the column sums along 'p' and a pmax along 'q' for One
# (the transpose for Inf), and psums of the scaled sums of squares for Fro.


def _local_counts(layout: TileLayout, grid, device) -> Tuple[torch.Tensor, torch.Tensor]:
    rows, cols = _layout_tensors(layout, device)[:2]
    r, c = grid.position
    return (rows[r * layout.mtl:(r + 1) * layout.mtl],
            cols[c * layout.ntl:(c + 1) * layout.ntl])


def _natural(local: torch.Tensor, grid, axis: str, scatter: torch.Tensor,
             length: int) -> torch.Tensor:
    """Per-slot sums of this rank's slots along ``axis`` (ntl or mtl,
    nb) -> the natural-order (length,) vector on every rank."""
    full = coll.all_gather(local, grid, axis)
    return full.reshape(-1, full.shape[-1])[scatter].reshape(-1)[:length]


def _mesh_sums(absA: torch.Tensor, layout: TileLayout, grid, which: str,
               natural: bool = False) -> torch.Tensor:
    """Column ('one') or row ('inf') sums of |A| from the per-tile sums of
    the local block: the full sums of this rank's slots (psum along the
    other axis), or with ``natural`` the (n,) / (m,) vector."""
    mtl, ntl, mb, nb = absA.shape
    if which == "one":
        part = coll.psum(absA.sum(dim=(0, 2)), grid, coll.ROW_AXIS)  # (ntl, nb)
        if natural:
            return _natural(part, grid, coll.COL_AXIS,
                            _layout_tensors(layout, absA.device)[3], layout.n)
        return part
    part = coll.psum(absA.sum(dim=(1, 3)), grid, coll.COL_AXIS)  # (mtl, mb)
    if natural:
        return _natural(part, grid, coll.ROW_AXIS,
                        _layout_tensors(layout, absA.device)[2], layout.m)
    return part


def mesh_genorm(norm: Norm, T: torch.Tensor, layout: TileLayout, grid,
                scope: NormScope = NormScope.Matrix) -> torch.Tensor:
    """``genorm`` of a matrix whose block on this rank is T: tile_norms
    on the local tiles (|T| for a complex T), then the explicit
    reduction over the mesh.  The Max norm is the single-device one bit
    for bit; the sums differ from it by rounding only."""
    A = T.abs() if T.is_complex() else T
    if A.stride(-1) != 1:  # a resolved transposed view
        A = A.contiguous()
    mtl, ntl, mb, nb = A.shape
    rows, cols = _local_counts(layout, grid, A.device)
    stack = A.reshape(mtl * ntl, mb, nb)

    def stats(kind, **fro):
        return pk.tile_norms(stack, kind, rows=rows, cols=cols, **fro)

    def col_sums():  # this rank's column slots, summed over the whole grid column
        return coll.psum(stats("one").view(mtl, ntl, nb).sum(dim=0), grid, coll.ROW_AXIS)

    def row_sums():
        return coll.psum(stats("inf").view(mtl, ntl, mb).sum(dim=1), grid, coll.COL_AXIS)

    if scope == NormScope.Columns:
        if norm != Norm.One:
            raise SlateError("column-scope norm supports Norm.One (colNorms)")
        return _natural(col_sums(), grid, coll.COL_AXIS,
                        _layout_tensors(layout, A.device)[3], layout.n)
    if scope == NormScope.Rows:
        if norm != Norm.Inf:
            raise SlateError("row-scope norm supports Norm.Inf")
        return _natural(row_sums(), grid, coll.ROW_AXIS,
                        _layout_tensors(layout, A.device)[2], layout.m)
    if norm == Norm.Max:
        return coll.pmax(stats("max").amax(), grid)
    if norm == Norm.One:
        return coll.pmax(col_sums().amax(), grid, coll.COL_AXIS)
    if norm == Norm.Inf:
        return coll.pmax(row_sums().amax(), grid, coll.ROW_AXIS)
    if norm == Norm.Fro:
        amax, s0 = stats("max_sumsq").unbind(1)
        amax = coll.pmax(amax.amax(), grid)
        s0 = coll.psum(s0.sum(), grid)
        fi = torch.finfo(A.dtype)
        ok = amax.clamp(fi.tiny ** 0.5 / fi.eps,
                        (fi.max / max(layout.m * layout.n, 1)) ** 0.5) == amax
        safe = torch.where(amax == 0, 1, amax)
        s1 = coll.psum(stats("fro_sumsq", scale=safe, skip=ok).sum(), grid)
        return torch.sqrt(torch.where(ok, s0, s1)) * torch.where(ok, 1, safe)
    raise SlateError(f"unsupported norm {norm}")


def mesh_masked_norm(kind: str, norm: Norm, T: torch.Tensor, layout: TileLayout, grid,
                     uplo: Uplo, diag: Diag = Diag.NonUnit) -> torch.Tensor:
    """``trnorm`` (kind 'tr') or ``synorm`` / ``henorm`` (kind 'sy') of a
    matrix whose block on this rank is T: the masked reductions of the
    single-device norms on the local block, reduced over the mesh."""
    dev = T.device
    if kind == "tr":
        absA = _masked(T.abs(), tri_mask(layout, uplo, Diag.NonUnit, device=dev, grid=grid))
        if diag == Diag.Unit:
            absA = torch.where(diag_mask(layout, dev, grid), 1, absA)
        parts = [(absA, 1)]
    else:
        absS = _masked(T.abs(), tri_mask(layout, uplo, Diag.Unit, device=dev, grid=grid))
        absD = _masked(T.abs(), diag_mask(layout, dev, grid))
        parts = [(absS, 2), (absD, 1)]
    amax = coll.pmax(torch.stack([a.amax() for a, _ in parts]).amax(), grid)
    if norm == Norm.Max:
        return amax
    if norm == Norm.Fro:
        return _scaled_fro(amax, lambda safe: coll.psum(
            sum(((a / safe) ** 2).sum() * w for a, w in parts), grid))
    if kind == "tr":
        which = "one" if norm == Norm.One else "inf" if norm == Norm.Inf else None
        if which is None:
            raise SlateError(f"unsupported norm {norm}")
        axis = coll.COL_AXIS if which == "one" else coll.ROW_AXIS
        return coll.pmax(_mesh_sums(absA, layout, grid, which).amax(), grid, axis)
    if norm in (Norm.One, Norm.Inf):
        # column sums of the strict triangle + its row sums (the mirror)
        # + the diagonal, in natural order
        return (_mesh_sums(absS, layout, grid, "one", natural=True)
                + _mesh_sums(absS, layout, grid, "inf", natural=True)
                + _mesh_sums(absD, layout, grid, "one", natural=True)).amax()
    raise SlateError(f"unsupported norm {norm}")
