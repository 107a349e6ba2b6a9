"""parallel layer of slate_tpu_torch: the process grids (``ProcessGrid``;
``ProcessGrid.from_ranks`` is the mesh constructor), the tile layout,
the collectives of a mesh and its SPMD kernels."""

from .grid import ProcessGrid, default_grid, set_default_grid

__all__ = ["ProcessGrid", "default_grid", "set_default_grid"]
