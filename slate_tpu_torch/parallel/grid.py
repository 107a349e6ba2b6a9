"""Process grid, the single-device part (reference: BaseMatrix.hh:80-122).

A ``ProcessGrid`` names the device a matrix lives on and the p x q
shape of its logical process grid.  ``ProcessGrid.single()`` is the 1x1
grid on ``cuda:0``: there is no silent fall back to the CPU, and a
caller who wants the CPU asks for it (``ProcessGrid.single("cpu")``).
Meshes over several devices (``torch.distributed``) come in a later
slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

from ..enums import GridOrder
from ..exceptions import DistributedException


@dataclass(frozen=True)
class ProcessGrid:
    """A p x q logical grid whose tiles all live on ``device``."""

    device: torch.device
    p: int = 1
    q: int = 1
    order: GridOrder = GridOrder.Col

    @property
    def size(self) -> int:
        return self.p * self.q

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
