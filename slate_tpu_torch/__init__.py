"""slate_tpu_torch — the PyTorch / CUDA port of slate_tpu for NVIDIA Hopper.

The JAX package ``slate_tpu`` stays beside it as the reference; this
package imports neither JAX nor anything of it.  It carries the
single-device Cholesky, LU and QR / least-squares solve paths: the tile
layout and matrix classes, the recursive-schedule factorizations
(``potrf``/``posv``, ``getrf``/``gesv`` with partial pivoting, no
pivoting or the random butterfly transform, ``getri``, ``geqrf``,
``gelqf``, ``cholqr``, ``gels``), the solve phases (``potrs``,
``getrs``, ``unmqr``/``unmlq``, ``potrs_from_global``,
``getrs_from_global``, ``gels_solve_from_global``), the BLAS3 routines
they use (``gemm``, ``herk``, ``syrk``, ``trsm``), and the norm and
elementwise drivers (``norm``, ``colNorms``, ``add``, ``copy``,
``scale``, ``scale_row_col``, ``set``, ``set_lambdas``).  Every Pallas
kernel of the JAX package is rewritten by hand in CUDA C++ for Hopper
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
    TrapezoidMatrix,
    TriangularMatrix,
)
from .drivers.aux import add, colNorms, copy, norm, scale, scale_row_col, set, set_lambdas
from .drivers.blas3 import gemm, herk, syrk, trsm
from .drivers.chol import posv, potrf, potrs, potrs_from_global
from .drivers.lu import (
    gerbt,
    gesv,
    gesv_nopiv,
    gesv_rbt,
    getrf,
    getrf_nopiv,
    getri,
    getrs,
    getrs_from_global,
    getrs_nopiv,
)
from .drivers.qr import (
    cholqr,
    gelqf,
    gels,
    gels_solve_from_global,
    geqrf,
    ungqr,
    unmlq,
    unmqr,
)
from .types import Pivots, TriangularFactors
from .convert import (
    geqrf_from_reference,
    getrf_from_reference,
    matrix_from_reference,
    pivots_from_reference,
)

__version__ = "0.1.0"

__all__ = [name for name in dir() if not name.startswith("_")]
