"""Process grid (reference: BaseMatrix.hh:80-122, func.hh:207).

A ``ProcessGrid`` names the device a matrix lives on and the p x q shape
of its process grid.  ``ProcessGrid.single()`` is the 1x1 grid on
``cuda:0``: there is no silent fall back to the CPU, and a caller who
wants the CPU asks for it (``ProcessGrid.single("cpu")``).

``ProcessGrid.from_ranks`` builds a p x q mesh over ``torch.distributed``,
one process a device, as SLATE's MPI grid is (the JAX package's
``from_devices`` over a ``jax.sharding.Mesh`` is single-controller; this
port is multi-controller).  Every rank of the default process group
calls it, in the same order; it creates the grid's process group and
its p row and q column subgroups collectively.  Rank k of the grid's
rank list sits at (k % p, k // p) for ``GridOrder.Col`` and at
(k // q, k % q) for ``GridOrder.Row``.  The device is
``cuda:{LOCAL_RANK}`` with an NCCL process group unless the caller
passes ``device="cpu"`` (gloo); a CUDA grid on gloo or a CPU grid on
NCCL raises.

Each rank holds only its own block of a matrix's storage-order tile
tensor (see layout.py): with the owner-major layout that block is one
contiguous slice, so the JAX package's ``PartitionSpec('p', 'q')``
sharding becomes "keep rows [r mtl, (r+1) mtl) and columns
[c ntl, (c+1) ntl)".  The collectives over the row ('q') and column
('p') subgroups live in ``collectives.py``.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from ..enums import GridOrder
from ..exceptions import DistributedException

ROW_AXIS = "p"
COL_AXIS = "q"


def _factor_2d(n: int) -> tuple:
    """Most-square p x q factorization of n, p <= q."""
    p = int(math.isqrt(n))
    while n % p != 0:
        p -= 1
    return p, n // p


@dataclass(frozen=True)
class ProcessGrid:
    """A p x q grid whose tiles live on ``device``.

    A mesh (``from_ranks``) has ``ranks[r][c]``, the global rank at grid
    position (r, c), and ``rank``, this process's; each process holds
    its own block of the tiles.  Without ``ranks`` the grid is logical:
    one process holds every tile on ``device``, laid out for p x q (the
    JAX package's storage order, as ``convert.matrix_from_reference``
    keeps it).  The process groups are left out of equality and hash."""

    device: torch.device
    p: int = 1
    q: int = 1
    order: GridOrder = GridOrder.Col
    ranks: Optional[Tuple[Tuple[int, ...], ...]] = None
    rank: int = 0
    group: Any = field(default=None, compare=False, hash=False, repr=False)
    row_group: Any = field(default=None, compare=False, hash=False, repr=False)
    col_group: Any = field(default=None, compare=False, hash=False, repr=False)

    @property
    def size(self) -> int:
        return self.p * self.q

    @property
    def is_mesh(self) -> bool:
        """True for a grid of processes (``from_ranks``), False for a
        logical grid on one process."""
        return self.ranks is not None

    @property
    def is_distributed(self) -> bool:
        """True for a mesh of more than one process: a matrix on it holds
        only this process's block of its tiles."""
        return self.is_mesh and self.size > 1

    @property
    def position(self) -> Tuple[int, int]:
        """This process's (r, c)."""
        for r, row in enumerate(self.ranks or ()):
            if self.rank in row:
                return r, row.index(self.rank)
        raise DistributedException(f"rank {self.rank} is not on the grid {self.ranks}")

    @property
    def r(self) -> int:
        return self.position[0]

    @property
    def c(self) -> int:
        return self.position[1]

    def axis_ranks(self, axis: str) -> Tuple[int, ...]:
        """Global ranks along ``axis`` through this process, in axis
        order: 'q' is this process row (its c varies), 'p' this process
        column."""
        r, c = self.position
        if axis == COL_AXIS:
            return self.ranks[r]
        return tuple(row[c] for row in self.ranks)

    def axis_group(self, axis: str):
        return self.row_group if axis == COL_AXIS else self.col_group

    def transposed(self) -> "ProcessGrid":
        """The same processes as a q x p grid, each at (c, r): where the
        local blocks of a transposed matrix live (``BaseMatrix.resolved``)."""
        order = GridOrder.Row if self.order == GridOrder.Col else GridOrder.Col
        table = tuple(tuple(row[j] for row in self.ranks) for j in range(self.q))
        return ProcessGrid(self.device, self.q, self.p, order, table, self.rank,
                           self.group, self.col_group, self.row_group)

    # -- constructors -------------------------------------------------------

    @staticmethod
    def single(device: Optional[Union[str, torch.device]] = None) -> "ProcessGrid":
        """1x1 grid on one device; ``None`` means ``cuda:0`` and raises
        when no CUDA device is present."""
        if device is None:
            if not torch.cuda.is_available():
                raise DistributedException(
                    "ProcessGrid.single(): no CUDA device; pass a device "
                    "(e.g. 'cpu') to run elsewhere"
                )
            device = "cuda:0"
        return ProcessGrid(torch.device(device))

    @staticmethod
    def from_ranks(
        ranks: Optional[Sequence[int]] = None,
        p: Optional[int] = None,
        q: Optional[int] = None,
        order: GridOrder = GridOrder.Col,
        device: Optional[Union[str, torch.device]] = None,
    ) -> Optional["ProcessGrid"]:
        """A p x q mesh over ``ranks`` of the default process group (all of
        them by default), collective over that group: every rank calls it
        with the same arguments, and a rank outside ``ranks`` gets None.
        p and q default to the most square factorization of the rank
        count."""
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized():
            raise DistributedException(
                "ProcessGrid.from_ranks(): torch.distributed is not initialized; "
                "call init_process_group (NCCL on GPUs, gloo on the CPU) first")
        world = dist.get_world_size()
        ranks = list(range(world)) if ranks is None else [int(k) for k in ranks]
        n = len(ranks)
        if (p is not None and p <= 0) or (q is not None and q <= 0):
            raise DistributedException(f"grid dims must be positive, got {p}x{q}")
        if p is None and q is None:
            p, q = _factor_2d(n)
        elif p is None:
            p = n // q
        elif q is None:
            q = n // p
        if p * q != n:
            raise DistributedException(f"grid {p}x{q} does not match device count {n}")
        if len(set(ranks)) != n or not all(0 <= k < world for k in ranks):
            raise DistributedException(f"grid ranks {ranks} are not distinct ranks of a "
                                       f"world of {world}")
        if order == GridOrder.Col:
            table = tuple(tuple(ranks[c * p + r] for c in range(q)) for r in range(p))
        else:
            table = tuple(tuple(ranks[r * q + c] for c in range(q)) for r in range(p))
        dev = _grid_device(device, dist.get_backend())
        # every rank of the world creates every group, in one order
        group = dist.group.WORLD if sorted(ranks) == list(range(world)) else \
            dist.new_group(sorted(ranks))
        me = dist.get_rank()
        row_group = col_group = None
        for r in range(p):
            g = dist.new_group(sorted(table[r]))
            if me in table[r]:
                row_group = g
        for c in range(q):
            members = [table[r][c] for r in range(p)]
            g = dist.new_group(sorted(members))
            if me in members:
                col_group = g
        if me not in ranks:
            return None
        return ProcessGrid(dev, p, q, order, table, me, group, row_group, col_group)


def _grid_device(device, backend: str) -> torch.device:
    """The grid's device: ``cuda:{LOCAL_RANK}`` on NCCL unless the caller
    names one; a device the backend cannot serve raises."""
    nccl = str(backend).lower() == "nccl"
    if device is None:
        if not torch.cuda.is_available():
            raise DistributedException(
                "ProcessGrid.from_ranks(): no CUDA device; pass device='cpu' "
                "(with a gloo process group) to run on the CPU")
        dev = torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not nccl:
        raise DistributedException(
            f"ProcessGrid.from_ranks(): a {dev} grid needs an NCCL process group, "
            f"not {backend}")
    if dev.type != "cuda" and nccl:
        raise DistributedException(
            f"ProcessGrid.from_ranks(): a {dev} grid cannot run on an NCCL process group")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


_default_grid: Optional[ProcessGrid] = None


def default_grid() -> ProcessGrid:
    """Module-level default grid: 1x1 on ``cuda:0`` (see ``single``)."""
    global _default_grid
    if _default_grid is None:
        _default_grid = ProcessGrid.single()
    return _default_grid


def set_default_grid(grid: ProcessGrid) -> None:
    global _default_grid
    _default_grid = grid
