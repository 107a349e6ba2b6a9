"""slate_tpu_torch.refine — mixed-precision iterative-refinement solvers
(the port of the JAX package's ``refine/``).

Factor once in a cheap precision, refine the solution in the working
precision (reference: SLATE's gesv_mixed / gesv_mixed_gmres /
posv_mixed family, src/gesv_mixed.cc; Carson & Higham SISC 2018 for the
three-precision framework).  On the H100 the float32 factor runs the
Hopper kernels (chol_base, syrk_diag, gemm_sub; panel_lu) under a
float64 solve.

Layout:

* :mod:`.policy` — precision-pair selection (working/factor/residual),
  by the operand's device type, routed through ``Option.MaxIterations``
  / ``Option.Tolerance`` / ``Option.UseFallbackSolver`` /
  ``Option.RefineMethod``.
* :mod:`.ir` — classical IR: a host loop with full-precision residual
  products and a componentwise backward-error stopping test.
* :mod:`.gmres` — restarted GMRES-IR preconditioned by the low-precision
  factors (survives ~1/eps_factor more ill-conditioning than classical
  IR).

The user-facing drivers live in :mod:`slate_tpu_torch.drivers.mixed`
(``gesv_mixed``, ``posv_mixed``, ``*_mixed_gmres``).
"""

from .gmres import GmresResult, gmres_refine
from .ir import RefineResult, backward_error, refine_while
from .policy import (
    GMRES_RESTART,
    Policy,
    default_tolerance,
    factor_dtype,
    select,
)

__all__ = [
    "GMRES_RESTART",
    "GmresResult",
    "Policy",
    "RefineResult",
    "backward_error",
    "default_tolerance",
    "factor_dtype",
    "gmres_refine",
    "refine_while",
    "select",
]
