"""Tile distribution functions (reference: include/slate/func.hh:39-265),
this package's own copy of the JAX package's ``func.py`` (pure Python).

These map tile indices (i, j) to block sizes, process ranks, or devices.
They serve two roles:

1. API parity — users of the reference construct matrices with these
   lambdas; here they configure a ``TileLayout``.
2. Compat ingestion — ``is_2d_cyclic_grid`` detects whether an arbitrary
   lambda is a plain 2D cyclic grid, so it can be mapped onto a process
   grid without a gather/redistribute.
"""

from __future__ import annotations

from typing import Callable, Tuple

from .enums import GridOrder
from .exceptions import slate_assert

IJFunc = Callable[[Tuple[int, int]], int]
SizeFunc = Callable[[int], int]


def uniform_blocksize(n: int, nb: int) -> SizeFunc:
    """Block i size = nb, except a short last block (reference: func.hh:39-43)."""
    return lambda j: (n % nb) if (j + 1) * nb > n and n % nb != 0 else nb


def max_blocksize(nt: int, size: SizeFunc) -> int:
    """Largest block under ``size`` over nt tiles (reference: func.hh:57-66)."""
    return max((size(i) for i in range(nt)), default=0)


def device_2d_grid(order: GridOrder, m: int, n: int, p: int, q: int) -> IJFunc:
    """2D block-cyclic map with m x n tile blocks (reference: func.hh:100-116)."""
    slate_assert(order != GridOrder.Unknown, "grid order must be Col or Row")
    if order == GridOrder.Col:
        return lambda ij: int((ij[0] // m) % p + ((ij[1] // n) % q) * p)
    return lambda ij: int(((ij[0] // m) % p) * q + (ij[1] // n) % q)


def device_1d_grid(order: GridOrder, block_size: int, size: int) -> IJFunc:
    """1D block-cyclic map (reference: func.hh:145-158)."""
    slate_assert(order != GridOrder.Unknown, "grid order must be Col or Row")
    if order == GridOrder.Col:
        return device_2d_grid(order, block_size, 1, size, 1)
    return device_2d_grid(order, 1, block_size, 1, size)


def round_robin(size: int) -> IJFunc:
    """Round-robin over flattened (i, j) (reference: func.hh:178 family)."""
    return lambda ij: int((ij[0] + ij[1]) % size)


def process_2d_grid(order: GridOrder, p: int, q: int) -> IJFunc:
    """Tile-cyclic 2D process grid (reference: func.hh:207-214)."""
    return device_2d_grid(order, 1, 1, p, q)


def process_1d_grid(order: GridOrder, size: int) -> IJFunc:
    """Tile-cyclic 1D process grid (reference: func.hh:218-226)."""
    slate_assert(order != GridOrder.Unknown, "grid order must be Col or Row")
    if order == GridOrder.Col:
        return process_2d_grid(order, size, 1)
    return process_2d_grid(order, 1, size)


def transpose_grid(old_func: IJFunc) -> IJFunc:
    """Swap (i, j) before applying ``old_func`` (reference: func.hh:229-238)."""
    return lambda ij: old_func((ij[1], ij[0]))


def is_2d_cyclic_grid(
    mt: int, nt: int, func: IJFunc
) -> Tuple[bool, GridOrder, int, int]:
    """Detect whether ``func`` equals process_2d_grid(order, p, q) on the
    mt x nt tile grid (reference: func.hh:265+).

    Returns (is_cyclic, order, p, q); (False, Unknown, -1, -1) otherwise.
    """
    if mt == 0 or nt == 0 or (mt == 1 and nt == 1):
        return True, GridOrder.Col, 1, 1

    # p = first row where column 0 repeats rank of row 0; q likewise.
    base = func((0, 0))
    p = mt
    for i in range(1, mt):
        if func((i, 0)) == base:
            p = i
            break
    q = nt
    for j in range(1, nt):
        if func((0, j)) == base:
            q = j
            break

    for order in (GridOrder.Col, GridOrder.Row):
        cand = process_2d_grid(order, p, q)
        ok = all(
            func((i, j)) == cand((i, j)) for i in range(mt) for j in range(nt)
        )
        if ok:
            # 1-row/1-col grids are order-ambiguous; report Col like the ref.
            return True, order if (p > 1 and q > 1) else GridOrder.Col, p, q
    return False, GridOrder.Unknown, -1, -1
