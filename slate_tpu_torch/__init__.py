"""slate_tpu_torch — the PyTorch / CUDA port of slate_tpu for NVIDIA Hopper.

The JAX package ``slate_tpu`` stays beside it as the reference; this
package imports neither JAX nor anything of it.  This slice carries the
single-device Cholesky solve path: the tile layout and matrix classes,
the recursive-schedule factorization (``potrf``/``posv``) and the
solve phase (``potrs``, ``potrs_from_global``), with the JAX package's
Pallas kernels rewritten by hand in CUDA C++ for Hopper
(``ops/hopper/panel_kernels.py``, sources in ``csrc/``).

Entry points run on ``cuda:0`` unless the caller asks for another
device (``ProcessGrid.single("cpu")``).
"""

from .enums import (
    Diag,
    GridOrder,
    Layout,
    MethodCholQR,
    MethodEig,
    MethodGels,
    MethodGemm,
    MethodHemm,
    MethodLU,
    MethodSVD,
    MethodTrsm,
    Norm,
    NormScope,
    Op,
    Option,
    RefineMethod,
    Schedule,
    Side,
    Target,
    TileKind,
    Uplo,
)
from .exceptions import (
    DimensionError,
    DistributedException,
    NumericalError,
    OptionError,
    SlateError,
)
from .options import get_option, normalize_options
from .parallel.grid import ProcessGrid, default_grid, set_default_grid
from .parallel.layout import TileLayout
from .matrix.base import conj_transpose, transpose
from .matrix.matrix import (
    BaseTrapezoidMatrix,
    HermitianMatrix,
    Matrix,
    SymmetricMatrix,
    TriangularMatrix,
)
from .drivers.blas3 import trsm
from .drivers.chol import posv, potrf, potrs, potrs_from_global
from .convert import matrix_from_reference

__version__ = "0.1.0"

__all__ = [name for name in dir() if not name.startswith("_")]
