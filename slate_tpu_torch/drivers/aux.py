"""Auxiliary elementwise and norm drivers (reference: src/add.cc,
copy.cc, scale.cc, scale_row_col.cc, set.cc, norm.cc, colNorms.cc), the
single-device part of the JAX package's ``drivers/aux.py``.

``norm`` of a general matrix takes its per-tile statistics from the
Hopper ``tile_norms`` kernel on a CUDA device; the Hermitian, symmetric
and triangular norms reduce with plain tensor operations, as in the JAX
package.  ``redistribute`` (meshes, ROADMAP.md Queue 1 item 8) and
``print_matrix`` come later.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..enums import Norm, NormScope, Uplo
from ..exceptions import DimensionError
from ..internal import norms as _norms
from ..internal import tile_ops
from ..matrix.base import BaseMatrix
from ..matrix.matrix import BaseTrapezoidMatrix, HermitianMatrix, SymmetricMatrix
from ..parallel.layout import tiles_from_global


def _check_same_shape(A: BaseMatrix, B: BaseMatrix) -> None:
    if (A.m, A.n) != (B.m, B.n):
        raise DimensionError(f"shape mismatch {A.m}x{A.n} vs {B.m}x{B.n}")


def _is_trapezoid(A: BaseMatrix) -> bool:
    return isinstance(A, BaseTrapezoidMatrix) and A.uplo != Uplo.General


def add(alpha, A: BaseMatrix, beta, B: BaseMatrix, opts=None) -> BaseMatrix:
    """B = alpha A + beta B (reference: src/add.cc -> internal geadd/tzadd)."""
    _check_same_shape(A, B)
    Ar, Br = A.resolved(), B.resolved()
    if Ar.layout == Br.layout:
        if _is_trapezoid(B):
            out = tile_ops.tzadd(Br.tri_mask(), alpha, Ar.data, beta, Br.data)
        else:
            out = tile_ops.geadd(alpha, Ar.data, beta, Br.data)
        return Br._with(data=out)
    # different layouts: through the global tensors
    out2d = alpha * Ar.to_global() + beta * Br.to_global()
    return Br._with(data=tiles_from_global(out2d.to(B.dtype), Br.layout))


def copy(A: BaseMatrix, B: BaseMatrix, opts=None) -> BaseMatrix:
    """B = A with optional precision conversion (reference: src/copy.cc)."""
    _check_same_shape(A, B)
    Ar, Br = A.resolved(), B.resolved()
    if Ar.layout == Br.layout:
        return Br._with(data=Ar.data.to(B.dtype))
    return Br._with(data=tiles_from_global(Ar.to_global().to(B.dtype), Br.layout))


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
    return Ar._with(data=tile_ops.gescale_row_col(Ar.layout, R, C, Ar.data))


def set(offdiag_value, diag_value, A: BaseMatrix, opts=None) -> BaseMatrix:  # noqa: A001
    """A = offdiag everywhere, diag on the diagonal (reference: src/set.cc)."""
    Ar = A.resolved()
    if _is_trapezoid(A):
        out = tile_ops.tzset(Ar.layout, Ar.uplo, offdiag_value, diag_value, Ar.data)
    else:
        out = tile_ops.geset(Ar.layout, offdiag_value, diag_value, Ar.data)
    return Ar._with(data=out)


def set_lambdas(value_fn: Callable, A: BaseMatrix, opts=None) -> BaseMatrix:
    """A[i, j] = value_fn(i, j) over the global indices (reference:
    src/set.cc, the lambda variant).  value_fn receives broadcast (i, j)
    index tensors on A's device; it is evaluated on the valid elements
    only, and the padding stays 0."""
    Ar = A.resolved()
    lay = Ar.layout
    dev = Ar.data.device
    gr = torch.as_tensor(lay.global_rows_np, device=dev)[:, None, :, None]
    gc = torch.as_tensor(lay.global_cols_np, device=dev)[None, :, None, :]
    vals = torch.as_tensor(value_fn(gr, gc), device=dev).to(A.dtype)
    vals = torch.broadcast_to(vals, lay.storage_shape)
    return Ar._with(data=torch.where(lay.element_mask(dev), vals, 0))


def norm(norm_type: Norm, A: BaseMatrix, scope: NormScope = NormScope.Matrix, opts=None):
    """Matrix, column or row norms (reference: src/norm.cc dispatching to
    internal::genorm/synorm/henorm/trnorm), a 0-d tensor (a vector for
    a column or row scope) on A's device."""
    Ar = A.resolved()
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
