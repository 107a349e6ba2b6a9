"""slate_tpu_torch — the PyTorch / CUDA port of slate_tpu for NVIDIA Hopper.

The JAX package ``slate_tpu`` stays beside it as the reference; this
package imports neither JAX nor anything of it.  It carries the
single-device Cholesky, LU and QR / least-squares solve paths: the tile
layout and matrix classes, the recursive-schedule factorizations
(``potrf``/``posv``, ``getrf``/``gesv`` with partial pivoting, no
pivoting, tournament pivoting or the random butterfly transform,
``getri``, ``geqrf``, ``gelqf``, ``cholqr``, ``gels``), the solve phases
(``potrs``, ``getrs``, ``unmqr``/``unmlq``, ``potrs_from_global``,
``getrs_from_global``, ``gels_solve_from_global``), the inverses
(``trtri``, ``trtrm``, ``potri``) and condition estimators
(``gecondest``, ``pocondest``, ``trcondest``), the level-3 BLAS
(``gemm``, ``hemm``/``symm``, ``herk``/``syrk``, ``her2k``/``syr2k``,
``trmm``, ``trsm``), the norm and elementwise drivers (``norm``,
``colNorms``, ``add``, ``copy``, ``scale``, ``scale_row_col``, ``set``,
``set_lambdas``), the tile distribution functions (``func``), the
matrix generator (``matgen``: ``generate_matrix``, ``cond_matrix``),
the mixed-precision solvers (``gesv_mixed``, ``posv_mixed`` and their
GMRES-IR variants, over the ``refine`` subsystem), the band kinds and
solvers (``BandMatrix``, ``TriangularBandMatrix``,
``HermitianBandMatrix``; ``gbmm``, ``hbmm``, ``tbsm``, ``gbtrf``/``gbtrs``/
``gbsv``, ``pbtrf``/``pbtrs``/``pbsv`` on windowed band kernels), the
Hermitian-indefinite solvers (``hetrf``/``hetrs``/``hesv``: pivot-free
LDL^H, Aasen's LTL^H on the host, the random butterfly), the Hermitian
eigensolvers (``heev`` two-stage through ``he2hb``, the bulge chase and
divide and conquer; ``sterf``/``steqr``/``stedc``, ``unmtr_he2hb``,
``hegst``/``hegv``/``sygv``), the verb API of those slices (``simplified``) and the serving tier above them
(``serve``: buckets, the executable and factor caches, a one-lane
``SolverService`` and ``serve.gesv/posv/gels``).  Every Pallas kernel of the
JAX package is rewritten by hand in CUDA C++ for Hopper
(``ops/hopper/panel_kernels.py``, sources in ``csrc/``).

Entry points run on ``cuda:0`` unless the caller asks for another
device (``ProcessGrid.single("cpu")``).
"""

from . import func
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
    BandMatrix,
    BaseTrapezoidMatrix,
    HermitianBandMatrix,
    HermitianMatrix,
    Matrix,
    SymmetricMatrix,
    TrapezoidMatrix,
    TriangularBandMatrix,
    TriangularMatrix,
)
from .drivers.aux import add, colNorms, copy, norm, scale, scale_row_col, set, set_lambdas
from .drivers.blas3 import gemm, hemm, her2k, herk, symm, syr2k, syrk, trmm, trsm
from .drivers.chol import pocondest, posv, potrf, potri, potrs, potrs_from_global, trtri, trtrm
from .drivers.lu import (
    gecondest,
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
    trcondest,
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
from .drivers.mixed import gesv_mixed, gesv_mixed_gmres, posv_mixed, posv_mixed_gmres
from .drivers.band import gbmm, gbsv, gbtrf, gbtrs, hbmm, pbsv, pbtrf, pbtrs, tbsm
from .drivers.indefinite import hesv, hetrf, hetrs
from .drivers.eig import he2hb, heev, hegst, hegv, stedc, steqr, sterf, sygv, unmtr_he2hb
from .drivers.svd import bdsqr, ge2tb, svd, tb2bd, unmbr_ge2tb_left, unmbr_ge2tb_right
from .types import Pivots, TriangularFactors

# matgen (reference: include/slate/generate_matrix.hh)
from . import matgen
from .matgen.generate import generate_matrix

# simplified verb API (reference: include/slate/simplified_api.hh)
from . import simplified

# mixed-precision refinement subsystem (policy / IR / GMRES-IR cores)
from . import refine
# the serving tier (lazy: importing it pulls in no driver)
from . import serve
from .convert import (
    factor_entry_from_reference,
    ge2tb_from_reference,
    geqrf_from_reference,
    he2hb_from_reference,
    getrf_from_reference,
    matrix_from_reference,
    pivots_from_reference,
)

__version__ = "0.1.0"

__all__ = [name for name in dir() if not name.startswith("_")]
