"""slate_tpu_torch — the PyTorch / CUDA port of slate_tpu for NVIDIA Hopper.

The JAX package ``slate_tpu`` stays beside it as the reference; this
package imports neither JAX nor anything of it.  What it carries:

- the tile layout and matrix classes, dense and band, and the process
  grids: ``ProcessGrid.single`` (one device) and ``ProcessGrid.from_ranks``,
  a p x q mesh over ``torch.distributed`` (NCCL on GPUs, gloo on the
  CPU; one rank a device), each rank holding its block of the tiles;
- the level-3 BLAS (``gemm``, ``hemm``/``symm``, ``herk``/``syrk``,
  ``her2k``/``syr2k``, ``trmm``, ``trsm``) with their mesh paths (SUMMA,
  stationary-A, the triangle-aware kernels of ``parallel/spmd_blas.py``;
  ``trsm`` on a mesh raises until its pipeline is ported), the norm and
  elementwise drivers (``norm`` and ``colNorms``, on a mesh too,
  ``redistribute``, ``print_matrix``, ``add``, ``copy``, ``scale``,
  ``scale_row_col``, ``set``, ``set_lambdas``) and the gather-fallback
  accounting (``internal/fallbacks.py``);
- on one device: the Cholesky, LU (partial, none, tournament pivoting,
  the random butterfly; ``getri``) and QR / least-squares solvers with
  their solve phases, the inverses and condition estimators, the
  mixed-precision solvers (``refine``), the band and Hermitian-indefinite
  solvers, the Hermitian eigensolvers (``heev``, ``hegv``, the tridiagonal
  solvers) and the SVD (``svd``, ``ge2tb``, ``tb2bd``, ``bdsqr``); a
  distributed operand raises ``DistributedException``;
- the matrix generator (``matgen``), the tile distribution functions
  (``func``) and the verb API (``simplified``);
- the serving tier (``serve``: buckets, the executable and factor
  caches, the artifact store, a ``SolverService`` of replica lanes with
  the integrity and admission planes) and its planes: the factor fabric
  (``fabric``), the soak fabric (``soak``), the elastic capacity plane
  (``scale``) and the fleet tier (``fleet``).

Every Pallas kernel of the JAX package is rewritten by hand in CUDA C++
for Hopper (``ops/hopper/panel_kernels.py``, sources in ``csrc/``).
Entry points run on ``cuda:0`` unless the caller asks for another
device (``ProcessGrid.single("cpu")``, or ``device="cpu"`` for a mesh).
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
from .drivers.aux import (
    add,
    colNorms,
    copy,
    norm,
    print_matrix,
    redistribute,
    scale,
    scale_row_col,
    set,
    set_lambdas,
)
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
