"""The JAX package's ``shard_map`` collectives on ``torch.distributed``
(the counterpart of ``slate_tpu/parallel/spmd_blas.py:44 shard_map``).

A ``shard_map`` body of the JAX package runs as the same body on every
rank of a mesh (``grid.ProcessGrid.from_ranks``), each rank holding its
local block of the tile tensors, and its collectives map one for one:

* ``lax.all_gather(x, axis)``      -> :func:`all_gather`: the blocks of
  the ranks along ``axis`` ('q': this process row, 'p': this process
  column), stacked in axis order (:func:`all_gather_async` issues it
  with ``async_op=True`` and waits when its result is asked for);
* ``lax.psum(x, axis)``            -> :func:`psum` (``all_reduce`` SUM);
* ``lax.psum_scatter(x, axis, scatter_dimension=d, tiled=True)``
                                   -> :func:`psum_scatter`
  (``reduce_scatter``, the list form);
* ``lax.pmax``                     -> :func:`pmax`;
* ``lax.axis_index(axis)``         -> ``grid.r`` ('p') / ``grid.c`` ('q').

A complex tensor travels as its real view (``view_as_real``): NCCL has
no complex type, and a sum of the real view is the complex sum.  Only
APIs present without deprecation in torch 2.11 and 2.13 are used (the
list forms of ``all_gather`` and ``reduce_scatter``, ``all_reduce``,
``gather``, ``isend`` / ``irecv``; 2.13 deprecates the ``*_tensor``
forms).  A group's ranks are ordered by global rank, which need not be
the axis order of a grid over a given rank list, so every gather and
scatter reorders by the grid's table.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from .grid import COL_AXIS, ROW_AXIS, ProcessGrid

__all__ = ["ROW_AXIS", "COL_AXIS", "all_gather", "all_gather_async", "psum", "pmax",
           "psum_scatter", "owner_bcast", "tile_column", "gather_blocks", "gather_to_root",
           "exchange"]


def _dist():
    import torch.distributed as dist

    return dist


def _wire(x: torch.Tensor) -> torch.Tensor:
    """The contiguous real tensor that goes through the collective."""
    x = x.resolve_conj().contiguous()
    return torch.view_as_real(x) if x.is_complex() else x


def _unwire(x: torch.Tensor, complex_: bool) -> torch.Tensor:
    return torch.view_as_complex(x) if complex_ else x


def _gather_list_async(x: torch.Tensor, members, group) -> Callable[[], List[torch.Tensor]]:
    """all_gather over ``group``, issued now; the returned call waits for
    it and gives one tensor a member, in ``members`` order."""
    w = _wire(x)
    bufs = [torch.empty_like(w) for _ in members]
    work = _dist().all_gather(bufs, w, group=group, async_op=True)

    def result(w=w) -> List[torch.Tensor]:  # w stays alive until the wait
        work.wait()
        by_rank = dict(zip(sorted(members), bufs))
        return [_unwire(by_rank[m], x.is_complex()) for m in members]

    return result


def _gather_list(x: torch.Tensor, members, group) -> List[torch.Tensor]:
    """all_gather over ``group`` -> one tensor a member, in ``members`` order."""
    return _gather_list_async(x, members, group)()


def all_gather_async(x: torch.Tensor, grid: ProcessGrid, axis: str) -> Callable[[], torch.Tensor]:
    """:func:`all_gather` issued now (``async_op=True``); the returned call
    waits for it (on NCCL the current stream waits, the host does not)
    and gives the (n_axis, *x.shape) result."""
    parts = _gather_list_async(x, grid.axis_ranks(axis), grid.axis_group(axis))
    return lambda: torch.stack(parts())


def all_gather(x: torch.Tensor, grid: ProcessGrid, axis: str) -> torch.Tensor:
    """``lax.all_gather(x, axis)``: (n_axis, *x.shape), in axis order."""
    return all_gather_async(x, grid, axis)()


def _reduce(x: torch.Tensor, grid: ProcessGrid, axis: Optional[str], op) -> torch.Tensor:
    w = _wire(x).clone()
    group = grid.group if axis is None else grid.axis_group(axis)
    _dist().all_reduce(w, op=op, group=group)
    return _unwire(w, x.is_complex())


def psum(x: torch.Tensor, grid: ProcessGrid, axis: Optional[str] = None) -> torch.Tensor:
    """``lax.psum(x, axis)``; over the whole grid with ``axis=None``."""
    return _reduce(x, grid, axis, _dist().ReduceOp.SUM)


def pmax(x: torch.Tensor, grid: ProcessGrid, axis: Optional[str] = None) -> torch.Tensor:
    """``lax.pmax(x, axis)`` of a real tensor; over the whole grid with
    ``axis=None``."""
    return _reduce(x, grid, axis, _dist().ReduceOp.MAX)


def psum_scatter(x: torch.Tensor, grid: ProcessGrid, axis: str, dim: int) -> torch.Tensor:
    """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
    the sum over ``axis`` of x, split in n_axis equal blocks along
    ``dim``; this rank keeps the block of its own axis index."""
    members = grid.axis_ranks(axis)
    blocks = torch.chunk(x, len(members), dim=dim)
    # the list form hands input g to the group's g-th rank (by global
    # rank): each rank's axis block goes there
    inp = [_wire(blocks[members.index(m)]) for m in sorted(members)]
    out = torch.empty_like(inp[0])
    _dist().reduce_scatter(out, inp, op=_dist().ReduceOp.SUM, group=grid.axis_group(axis))
    return _unwire(out, x.is_complex())


def owner_bcast(x: torch.Tensor, own: bool, grid: ProcessGrid, axis: str) -> torch.Tensor:
    """The owner's x on every rank along ``axis``: a psum of x masked to
    the owner (``lax.psum(jnp.where(own, x, 0), axis)``)."""
    return psum(x if own else torch.zeros_like(x), grid, axis)


def tile_column(T: torch.Tensor, k: int, grid: ProcessGrid) -> torch.Tensor:
    """Global tile column k of a storage-order block T on every rank of the
    mesh: its owner column's tiles gathered along 'q', then every process
    row's along 'p' (the JAX package's two ``lax.all_gather`` panel
    gathers) -- (p mtl, mb, nb) in storage tile-row order."""
    col = all_gather(T[:, k // grid.q], grid, COL_AXIS)[k % grid.q]
    full = all_gather(col, grid, ROW_AXIS)
    return full.reshape((-1,) + tuple(full.shape[2:]))


def gather_blocks(x: torch.Tensor, grid: ProcessGrid) -> List[List[torch.Tensor]]:
    """Every rank's block of the grid (an all_gather over the grid's
    group): ``blocks[r][c]`` is the block of the rank at (r, c)."""
    members = [k for row in grid.ranks for k in row]
    got = dict(zip(members, _gather_list(x, members, grid.group)))
    return [[got[k] for k in row] for row in grid.ranks]


def gather_to_root(x: torch.Tensor, grid: ProcessGrid) -> Optional[List[List[torch.Tensor]]]:
    """The blocks of the grid on its root, the rank at (0, 0) (``gather``;
    None on the other ranks)."""
    dist = _dist()
    root = grid.ranks[0][0]
    w = _wire(x)
    members = sorted(k for row in grid.ranks for k in row)
    bufs = [torch.empty_like(w) for _ in members] if grid.rank == root else None
    dist.gather(w, bufs, dst=root, group=grid.group)
    if bufs is None:
        return None
    got = {k: _unwire(b, x.is_complex()) for k, b in zip(members, bufs)}
    return [[got[k] for k in row] for row in grid.ranks]


def exchange(x: torch.Tensor, partner: int) -> torch.Tensor:
    """Send x to global rank ``partner`` and receive its tensor of the
    same shape and type (a pairwise swap; ``partner`` does the same)."""
    dist = _dist()
    w = _wire(x)
    got = torch.empty_like(w)
    reqs = [dist.isend(w, partner), dist.irecv(got, partner)]
    for req in reqs:
        req.wait()
    return _unwire(got, x.is_complex())
