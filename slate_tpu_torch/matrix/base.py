"""Matrix classes, shared behavior (reference: include/slate/BaseMatrix.hh).

As in the JAX package: routines return new matrices, storage is ONE
(P, Q, mb, nb) tile tensor in owner-major block-cyclic order (see
parallel/layout.py), and transpose is an O(1) op flag that internals
materialize with ``resolved()``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..enums import Diag, Op, Uplo
from ..exceptions import slate_assert
from ..parallel.grid import ProcessGrid
from ..parallel.layout import TileLayout, permute_tiles, tiles_to_global


class BaseMatrix:
    """Shared behavior for all matrix kinds.

    Attributes:
        data:   (P, Q, mb, nb) storage-order tile tensor.
        layout: static TileLayout index math.
        grid:   ProcessGrid or None (then the device is ``data.device``).
        op:     Op flag of this view (NoTrans/Trans/ConjTrans).
    """

    uplo: Uplo = Uplo.General
    diag: Diag = Diag.NonUnit

    def __init__(
        self,
        data: torch.Tensor,
        layout: TileLayout,
        grid: Optional[ProcessGrid] = None,
        op: Op = Op.NoTrans,
    ):
        slate_assert(
            tuple(data.shape) == layout.storage_shape,
            f"data shape {tuple(data.shape)} != layout {layout.storage_shape}",
        )
        self.data = data
        self.layout = layout
        self.grid = grid
        self.op = op

    # -- basic queries (reference: BaseMatrix.hh:211-223, mt/nt/m/n) --------

    @property
    def m(self) -> int:
        return self.layout.n if self.op != Op.NoTrans else self.layout.m

    @property
    def n(self) -> int:
        return self.layout.m if self.op != Op.NoTrans else self.layout.n

    @property
    def mt(self) -> int:
        return self.layout.nt if self.op != Op.NoTrans else self.layout.mt

    @property
    def nt(self) -> int:
        return self.layout.mt if self.op != Op.NoTrans else self.layout.nt

    @property
    def mb(self) -> int:
        return self.layout.nb if self.op != Op.NoTrans else self.layout.mb

    @property
    def nb(self) -> int:
        return self.layout.mb if self.op != Op.NoTrans else self.layout.nb

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def tileMb(self, i: int) -> int:
        return self.layout.tileNb(i) if self.op != Op.NoTrans else self.layout.tileMb(i)

    def tileNb(self, j: int) -> int:
        return self.layout.tileMb(j) if self.op != Op.NoTrans else self.layout.tileNb(j)

    def tileRank(self, i: int, j: int) -> Tuple[int, int]:
        if self.op != Op.NoTrans:
            r, c = self.layout.tileRank(j, i)
            return (c, r)
        return self.layout.tileRank(i, j)

    @property
    def is_complex(self) -> bool:
        return self.data.is_complex()

    # -- op handling (reference: BaseMatrix.hh transpose/conj_transpose) ----

    def _with(self, **kw) -> "BaseMatrix":
        """Copy with overridden fields; preserves every subclass attribute."""
        out = object.__new__(type(self))
        out.__dict__.update(self.__dict__)
        for k, v in kw.items():
            setattr(out, k, v)
        return out

    def resolved(self) -> "BaseMatrix":
        """Materialize the op flag into the data (internals see NoTrans):
        storage -> natural on both axes, swap, natural -> storage of A^T."""
        if self.op == Op.NoTrans:
            return self
        lay = self.layout
        T = permute_tiles(self.data, lay.row_scatter, lay.col_scatter)
        T = T.permute(1, 0, 3, 2)
        if self.op == Op.ConjTrans and T.is_complex():
            T = T.conj()
        lay_t = lay.transposed()
        T = permute_tiles(T, lay_t.row_gather, lay_t.col_gather).resolve_conj()
        out = self._with(data=T, layout=lay_t, op=Op.NoTrans)
        if getattr(self, "uplo", Uplo.General) == Uplo.Lower:
            out.uplo = Uplo.Upper
        elif getattr(self, "uplo", Uplo.General) == Uplo.Upper:
            out.uplo = Uplo.Lower
        return out

    # -- conversions --------------------------------------------------------

    def to_global(self) -> torch.Tensor:
        """Gather to the (m, n) global tensor, honoring the op flag."""
        A = tiles_to_global(self.data, self.layout)
        if self.op == Op.Trans:
            A = A.T
        elif self.op == Op.ConjTrans:
            A = A.mH
        return A

    def __repr__(self):
        return (
            f"{type(self).__name__}({self.m}x{self.n}, tiles {self.mb}x{self.nb}, "
            f"grid {self.layout.p}x{self.layout.q}, op={self.op.name}, "
            f"dtype={self.dtype}, device={self.device})"
        )


def is_distributed(M: BaseMatrix) -> bool:
    """True when M lives on a multi-process grid."""
    return M.grid is not None and M.grid.size > 1


def transpose(A: BaseMatrix) -> BaseMatrix:
    """O(1) transposed view (reference: slate::transpose, BaseMatrix.hh)."""
    new_op = {Op.NoTrans: Op.Trans, Op.Trans: Op.NoTrans, Op.ConjTrans: Op.NoTrans}[A.op]
    if A.op == Op.ConjTrans and A.is_complex:
        # transpose(conj_transpose(A)) = conj(A): materialize the conj
        return A._with(data=A.data.conj().resolve_conj(), op=Op.NoTrans)
    return A._with(op=new_op)


def conj_transpose(A: BaseMatrix) -> BaseMatrix:
    new_op = {Op.NoTrans: Op.ConjTrans, Op.ConjTrans: Op.NoTrans, Op.Trans: Op.NoTrans}[A.op]
    if A.op == Op.Trans and A.is_complex:
        return A._with(data=A.data.conj().resolve_conj(), op=Op.NoTrans)
    return A._with(op=new_op)
