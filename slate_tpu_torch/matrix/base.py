"""Matrix classes, shared behavior (reference: include/slate/BaseMatrix.hh).

As in the JAX package: routines return new matrices, storage is ONE
(P, Q, mb, nb) tile tensor in owner-major block-cyclic order (see
parallel/layout.py), and transpose is an O(1) op flag that internals
materialize with ``resolved()``.

On a mesh (``ProcessGrid.from_ranks`` with more than one process) each
rank holds only its block, (mtl, ntl, mb, nb) (``layout.local_block``):
``from_global`` keeps it, ``to_global`` gathers the blocks collectively
(every rank of the grid calls it), and ``resolved()`` of a transposed
view transposes the block in place, so its tiles live on the transposed
q x p grid; on a square mesh one exchange with the transposed partner
brings them back to the matrix's own grid, where the JAX package's p x p
sharding puts them.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..enums import Diag, Op, Uplo
from ..exceptions import DistributedException, slate_assert
from ..parallel import collectives
from ..parallel.grid import ProcessGrid
from ..parallel.layout import TileLayout, from_blocks, local_tiles, permute_tiles, tiles_to_global


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
        want = (layout.local_shape if grid is not None and grid.is_distributed
                else layout.storage_shape)
        slate_assert(
            tuple(data.shape) == want,
            f"data shape {tuple(data.shape)} != layout {want}",
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
        lay_t = lay.transposed()
        if is_distributed(self):
            # rank (r, c)'s tiles of A are A^T's tiles of position (c, r)
            # on the transposed grid, in the same local slots, transposed
            T = self.data.permute(1, 0, 3, 2)
            if self.op == Op.ConjTrans and T.is_complex():
                T = T.conj()
            T, grid = T.resolve_conj().contiguous(), self.grid.transposed()
            if grid.p == grid.q:
                # back on the matrix's own grid: swap with the rank at (c, r)
                r, c = self.grid.position
                if r != c:
                    T = collectives.exchange(T, self.grid.ranks[c][r])
                grid = self.grid
            out = self._with(data=T, layout=lay_t, op=Op.NoTrans, grid=grid)
        else:
            T = permute_tiles(self.data, lay.row_scatter, lay.col_scatter)
            T = T.permute(1, 0, 3, 2)
            if self.op == Op.ConjTrans and T.is_complex():
                T = T.conj()
            T = permute_tiles(T, lay_t.row_gather, lay_t.col_gather).resolve_conj()
            out = self._with(data=T, layout=lay_t, op=Op.NoTrans)
        if getattr(self, "uplo", Uplo.General) == Uplo.Lower:
            out.uplo = Uplo.Upper
        elif getattr(self, "uplo", Uplo.General) == Uplo.Upper:
            out.uplo = Uplo.Lower
        return out

    # -- conversions --------------------------------------------------------

    def storage(self) -> torch.Tensor:
        """The whole (P, Q, mb, nb) storage-order tile tensor: the data,
        or on a mesh every rank's block gathered (collective)."""
        if not is_distributed(self):
            return self.data
        return from_blocks(collectives.gather_blocks(self.data, self.grid))

    def to_global(self) -> torch.Tensor:
        """Gather to the (m, n) global tensor, honoring the op flag (on a
        mesh a collective: every rank of the grid gets it)."""
        A = tiles_to_global(self.storage(), self.layout)
        if self.op == Op.Trans:
            A = A.T
        elif self.op == Op.ConjTrans:
            A = A.mH
        return A

    def shard(self) -> "BaseMatrix":
        """On a mesh, keep this rank's block of whole storage-order data
        (the JAX package's placement with the cyclic sharding); data that
        is already a block, or a grid that is not a mesh, is left as is."""
        if not is_distributed(self) or tuple(self.data.shape) != self.layout.storage_shape:
            return self
        return self._with(data=local_tiles(self.data, self.layout, self.grid))

    def __repr__(self):
        return (
            f"{type(self).__name__}({self.m}x{self.n}, tiles {self.mb}x{self.nb}, "
            f"grid {self.layout.p}x{self.layout.q}, op={self.op.name}, "
            f"dtype={self.dtype}, device={self.device})"
        )


def is_distributed(M: BaseMatrix) -> bool:
    """True when M lives on a mesh of more than one process (its data is
    this rank's block): the predicate of every driver's mesh branch.  A
    logical p x q grid on one process is not distributed."""
    return M.grid is not None and M.grid.is_distributed


def on_mesh(M: BaseMatrix) -> bool:
    """True when M lives on a mesh of processes (``ProcessGrid.from_ranks``),
    a one-process mesh included: the predicate of the mesh branches of
    trsm, the factorizations and the solves (ROADMAP.md Queue 1 item
    8b1), which take their SPMD path on every mesh.  (The JAX package and
    the BLAS3 of item 8a route a one-device grid to the global path.)"""
    return M.grid is not None and M.grid.is_mesh


def refuse_distributed(routine: str, item: str, *mats) -> None:
    """Raise ``DistributedException`` when one of ``mats`` is distributed
    and ``routine``'s mesh path is not ported yet (ROADMAP.md Queue 1
    ``item``): no driver gathers a distributed operand where the JAX
    package runs its SPMD path."""
    if any(isinstance(M, BaseMatrix) and is_distributed(M) for M in mats):
        raise DistributedException(
            f"{routine}: distributed operands need its mesh path, which is not "
            f"ported yet (ROADMAP.md Queue 1 item {item})")


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


def single_device(item: str):
    """Decorator of a driver whose mesh path is ROADMAP.md Queue 1
    ``item``: a distributed matrix argument raises (``refuse_distributed``)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            refuse_distributed(fn.__name__, item, *args, *kw.values())
            return fn(*args, **kw)
        return wrapped
    return deco
