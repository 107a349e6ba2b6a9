"""Auxiliary elementwise and norm drivers (reference: src/add.cc,
copy.cc, scale.cc, scale_row_col.cc, set.cc, norm.cc, colNorms.cc,
print.cc, redistribute.cc), the port of the JAX package's
``drivers/aux.py``.

``norm`` of a general matrix takes its per-tile statistics from the
Hopper ``tile_norms`` kernel on a CUDA device; the Hermitian, symmetric
and triangular norms reduce with plain tensor operations, as in the JAX
package.  On a mesh each rank reduces its own tiles (``tile_norms`` for
a general matrix) and the reduction across the processes, GSPMD's in the
JAX package, is written out (``internal/norms.py`` ``mesh_genorm``).
The elementwise drivers act on each rank's block, with the masks and
index maps of that block; ``add`` and ``copy`` between different layouts
go through the global tensors, gathered collectively (the JAX package's
GSPMD route).  ``redistribute`` takes the SPMD two-phase re-send between
layouts of one mesh (``parallel/spmd_redistribute.py``) and otherwise the
recorded gather route; ``print_matrix`` gathers to the grid's root.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

import numpy as np

from ..enums import Norm, NormScope, Op, Uplo
from ..exceptions import DimensionError
from ..internal import fallbacks
from ..internal import norms as _norms
from ..internal import tile_ops
from ..matrix.base import BaseMatrix, is_distributed
from ..matrix.matrix import BaseTrapezoidMatrix, HermitianMatrix, SymmetricMatrix
from ..parallel import collectives
from ..parallel.layout import (from_blocks, index_maps, local_tiles, tiles_from_global,
                               tiles_to_global)


def _check_same_shape(A: BaseMatrix, B: BaseMatrix) -> None:
    if (A.m, A.n) != (B.m, B.n):
        raise DimensionError(f"shape mismatch {A.m}x{A.n} vs {B.m}x{B.n}")


def _same_tiles(Ar: BaseMatrix, Br: BaseMatrix) -> bool:
    """Ar's and Br's data hold the same tiles: one layout, and on a mesh
    one grid."""
    return Ar.layout == Br.layout and (
        Ar.grid == Br.grid or not (is_distributed(Ar) or is_distributed(Br)))


def _pack_like(G: torch.Tensor, Br: BaseMatrix) -> BaseMatrix:
    """A global (m, n) tensor as Br's tiles (its block on a mesh)."""
    return Br._with(data=local_tiles(tiles_from_global(G.to(Br.dtype), Br.layout),
                                     Br.layout, Br.grid))


def _is_trapezoid(A: BaseMatrix) -> bool:
    return isinstance(A, BaseTrapezoidMatrix) and A.uplo != Uplo.General


def add(alpha, A: BaseMatrix, beta, B: BaseMatrix, opts=None) -> BaseMatrix:
    """B = alpha A + beta B (reference: src/add.cc -> internal geadd/tzadd)."""
    _check_same_shape(A, B)
    Ar, Br = A.resolved(), B.resolved()
    if _same_tiles(Ar, Br):
        if _is_trapezoid(B):
            out = tile_ops.tzadd(Br.tri_mask(), alpha, Ar.data, beta, Br.data)
        else:
            out = tile_ops.geadd(alpha, Ar.data, beta, Br.data)
        return Br._with(data=out)
    # different layouts (or grids): through the global tensors
    return _pack_like(alpha * Ar.to_global() + beta * Br.to_global(), Br)


def copy(A: BaseMatrix, B: BaseMatrix, opts=None) -> BaseMatrix:
    """B = A with optional precision conversion (reference: src/copy.cc)."""
    _check_same_shape(A, B)
    Ar, Br = A.resolved(), B.resolved()
    if _same_tiles(Ar, Br):
        return Br._with(data=Ar.data.to(B.dtype))
    return _pack_like(Ar.to_global(), Br)


def scale(numer, denom, A: BaseMatrix, opts=None) -> BaseMatrix:
    """A *= numer / denom (reference: src/scale.cc)."""
    Ar = A.resolved()
    if _is_trapezoid(A):
        out = tile_ops.tzscale(Ar.tri_mask(), numer, denom, Ar.data)
    else:
        out = tile_ops.gescale(numer, denom, Ar.data)
    return Ar._with(data=out)


def scale_row_col(R: Optional[torch.Tensor], C: Optional[torch.Tensor], A: BaseMatrix,
                  opts=None) -> BaseMatrix:
    """A = diag(R) A diag(C) (reference: src/scale_row_col.cc, Equed)."""
    Ar = A.resolved()
    return Ar._with(data=tile_ops.gescale_row_col(Ar.layout, R, C, Ar.data, Ar.grid))


def set(offdiag_value, diag_value, A: BaseMatrix, opts=None) -> BaseMatrix:  # noqa: A001
    """A = offdiag everywhere, diag on the diagonal (reference: src/set.cc)."""
    Ar = A.resolved()
    if _is_trapezoid(A):
        out = tile_ops.tzset(Ar.layout, Ar.uplo, offdiag_value, diag_value, Ar.data, Ar.grid)
    else:
        out = tile_ops.geset(Ar.layout, offdiag_value, diag_value, Ar.data, Ar.grid)
    return Ar._with(data=out)


def set_lambdas(value_fn: Callable, A: BaseMatrix, opts=None) -> BaseMatrix:
    """A[i, j] = value_fn(i, j) over the global indices (reference:
    src/set.cc, the lambda variant).  value_fn receives broadcast (i, j)
    index tensors on A's device (on a mesh, those of this rank's block);
    it is evaluated on the valid elements only, and the padding stays 0."""
    Ar = A.resolved()
    dev = Ar.data.device
    gr, gc, valid = index_maps(Ar.layout, dev, Ar.grid)
    vals = torch.as_tensor(value_fn(gr, gc), device=dev).to(A.dtype)
    vals = torch.broadcast_to(vals, Ar.data.shape)
    return Ar._with(data=torch.where(valid, vals, 0))


def norm(norm_type: Norm, A: BaseMatrix, scope: NormScope = NormScope.Matrix, opts=None):
    """Matrix, column or row norms (reference: src/norm.cc dispatching to
    internal::genorm/synorm/henorm/trnorm), a 0-d tensor (a vector for
    a column or row scope) on A's device."""
    Ar = A.resolved()
    if is_distributed(Ar):
        if isinstance(A, SymmetricMatrix):  # HermitianMatrix too
            return _norms.mesh_masked_norm("sy", norm_type, Ar.data, Ar.layout, Ar.grid,
                                           Ar.uplo)
        if _is_trapezoid(A):
            return _norms.mesh_masked_norm("tr", norm_type, Ar.data, Ar.layout, Ar.grid,
                                           Ar.uplo, Ar.diag)
        return _norms.mesh_genorm(norm_type, Ar.data, Ar.layout, Ar.grid, scope)
    if isinstance(A, HermitianMatrix):
        return _norms.henorm(norm_type, Ar.data, Ar.layout, Ar.uplo)
    if isinstance(A, SymmetricMatrix):
        return _norms.synorm(norm_type, Ar.data, Ar.layout, Ar.uplo)
    if _is_trapezoid(A):
        return _norms.trnorm(norm_type, Ar.data, Ar.layout, Ar.uplo, Ar.diag)
    return _norms.genorm(norm_type, Ar.data, Ar.layout, scope)


def colNorms(norm_type: Norm, A: BaseMatrix, opts=None):  # noqa: N802 (reference name)
    """Per-column norms (reference: src/colNorms.cc, Norm.One scope)."""
    return norm(norm_type if norm_type else Norm.One, A, scope=NormScope.Columns)


def redistribute(A: BaseMatrix, B: BaseMatrix, opts=None) -> BaseMatrix:
    """Copy A into B's (different) distribution (reference:
    src/redistribute.cc -- per-tile sends between the two layouts).

    Operands on one mesh run the SPMD two-phase masked-psum re-send
    (``parallel/spmd_redistribute.py``: O(n^2/q + n^2/p) per process).
    Otherwise every rank gathers A and keeps B's block of it, and with a
    distributed operand that gather is recorded (``internal/fallbacks``)."""
    _check_same_shape(A, B)
    if ((is_distributed(A) or is_distributed(B))
            and A.op == Op.NoTrans and B.op == Op.NoTrans
            and (A.layout.p, A.layout.q) == (B.layout.p, B.layout.q)
            and A.grid == B.grid and A.layout.p * A.layout.q > 1):
        from ..parallel.spmd_redistribute import spmd_redistribute

        return B._with(data=spmd_redistribute(A.grid, A.data, A.layout, B.layout,
                                              out_dtype=B.dtype))
    if is_distributed(A) or is_distributed(B):
        fallbacks.record("redistribute", opts, "the element gather replicates A")
    return _pack_like(A.to_global(), B.resolved())


def print_matrix(label: str, A: BaseMatrix, opts=None, verbose: int = 4,
                 width: int = 10, precision: int = 4) -> str:
    """Matrix printing (reference: src/print.cc -- gathers to rank 0 and
    formats; PrintVerbose levels enums.hh:477-487).  On a mesh every
    rank of the grid calls it; the root, the rank at (0, 0), returns the
    text and the others an empty string."""
    if verbose <= 0:
        return ""
    header = (f"% {label}: {type(A).__name__} {A.m}x{A.n}, "
              f"tiles {A.mb}x{A.nb}, grid {A.layout.p}x{A.layout.q}\n")
    if verbose == 1:
        return header
    if is_distributed(A):
        blocks = collectives.gather_to_root(A.data, A.grid)
        if blocks is None:
            return ""
        G = tiles_to_global(from_blocks(blocks), A.layout)
        G = {Op.NoTrans: G, Op.Trans: G.T, Op.ConjTrans: G.mH}[A.op]
    else:
        G = A.to_global()
    G = G.resolve_conj().cpu().numpy()
    if verbose == 2:
        edge = 4
        G = np.block([[G[:edge, :edge], G[:edge, -edge:]],
                      [G[-edge:, :edge], G[-edge:, -edge:]]])
    fmt = f"%{width}.{precision}f"
    lines = []
    for row in G:
        if np.iscomplexobj(row):
            lines.append(" ".join((fmt % v.real) + ("+" + (fmt % v.imag).strip() + "i")
                                  for v in row))
        else:
            lines.append(" ".join(fmt % v for v in row))
    return header + label + " = [\n" + "\n".join(lines) + "\n]\n"
