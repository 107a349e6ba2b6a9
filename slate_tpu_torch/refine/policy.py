"""Precision-pair selection for mixed-precision refinement, the port of
the JAX package's ``refine/policy.py``.

A mixed-precision solve is shaped by three dtypes (Carson & Higham,
SIAM SISC 2018 — "iterative refinement in three precisions", and the
reference's gesv_mixed.cc which fixes the pair f64/f32):

* **working** — the dtype of the inputs and of the returned solution;
  the accuracy contract is stated in this precision's eps.
* **factor**  — the dtype the O(n^3) factorization runs in.
* **residual** — the dtype the O(n^2) residual is evaluated in.  No
  wider-than-working dtype is used, so the residual is computed *in*
  working precision with full-precision products
  (``internal.precision.hdot``: TF32 off).

Pairs are backend-aware (:func:`factor_dtype`); the backend is the type
of the operand's device (``"cpu"``, ``"cuda"``), or the JAX package's
accelerator row for any other name:

    working      accelerator factor       CPU factor               CUDA factor
    f64 / c128   f32 / c64                f32 / c64                f32 / c64
    f32          bfloat16                 f32 (degenerate pair)    f32 (degenerate pair)
    c64          c64 (no complex bf16)    c64 (degenerate pair)    c64 (degenerate pair)

The CUDA row keeps float32 working precision degenerate: torch has no
bfloat16 factorization or triangular solve (``cholesky``, ``lu_factor``
and ``solve_triangular`` raise for bfloat16, on the CPU and in cuSOLVER
/ cuBLAS alike), and the port's Hopper kernels take float32 and float64
only.  Mixed precision on the card means f32 factors under f64 working
precision, never TF32.

A *degenerate* pair (factor == working) is still well-defined: the
refinement loop converges on the first residual check and the solve
behaves like the direct solver plus one verification matmul — so
``gesv_mixed`` is always safe to call.

Everything is routed through the per-call Options the reference uses
for its mixed drivers: ``Option.MaxIterations`` (default 30),
``Option.Tolerance`` (componentwise-backward-error threshold; default
sqrt(n) * eps_working), ``Option.UseFallbackSolver`` (demote to a
full-precision direct solve on non-convergence, gesv_mixed_gmres.cc:
100-106), plus the extension ``Option.RefineMethod`` (ir | gmres |
auto).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..enums import Option, RefineMethod
from ..options import Options, get_option

#: GMRES restart length (reference: gesv_mixed_gmres.cc restart = 30)
GMRES_RESTART = 30

_FACTOR_ACCEL = {
    "float64": "float32",
    "complex128": "complex64",
    "float32": "bfloat16",
    # no complex half format exists; keep the pair degenerate
    "complex64": "complex64",
}
_FACTOR_CPU = {
    "float64": "float32",
    "complex128": "complex64",
    # CPU has no fast bf16 pipe worth a precision cut: degenerate pair
    "float32": "float32",
    "complex64": "complex64",
}
#: CUDA takes the CPU's table (no bfloat16 factorization or solve in
#: torch: the docstring's CUDA row); any other name takes _FACTOR_ACCEL
_FACTOR_BY_BACKEND = {"cpu": _FACTOR_CPU, "cuda": _FACTOR_CPU}

#: the backend a call without one is resolved for: the port's entry
#: points run on the card unless asked otherwise
DEFAULT_BACKEND = "cuda"


def _dtype_name(dtype) -> str:
    """Canonical dtype name ("float64", ...) of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


def factor_dtype(working, backend: Optional[str] = None):
    """The factorization dtype paired with ``working`` on ``backend``
    (``"cpu"``, ``"cuda"`` or an accelerator name; default
    :data:`DEFAULT_BACKEND`).  Returns a numpy dtype for the
    real/complex pairs and the string ``"bfloat16"`` for the f32
    accelerator pair (numpy has no bf16)."""
    name = _dtype_name(working)
    backend = backend or DEFAULT_BACKEND
    table = _FACTOR_BY_BACKEND.get(backend, _FACTOR_ACCEL)
    lo = table.get(name)
    if lo is None:
        raise ValueError(f"no mixed-precision pair for dtype {name!r}")
    return lo if lo == "bfloat16" else np.dtype(lo)


def default_tolerance(working, n: int) -> float:
    """Componentwise-backward-error stopping threshold:
    sqrt(n) * eps_working (the reference's gesv_mixed tolerance scaling;
    the refined berr settles at ~eps, so sqrt(n) headroom is ample
    without admitting an unconverged solution)."""
    return float(math.sqrt(max(n, 1)) * np.finfo(np.dtype(_dtype_name(working))).eps)


@dataclass(frozen=True)
class Policy:
    """One resolved mixed-precision solve configuration."""

    working: str  # canonical dtype name, e.g. "float64"
    factor: str  # factorization dtype name (may be "bfloat16")
    residual: str  # residual dtype name (== working)
    method: str  # "ir" | "gmres"
    max_iterations: int
    tolerance: float  # componentwise backward-error threshold
    use_fallback: bool
    restart: int = GMRES_RESTART

    @property
    def degenerate(self) -> bool:
        """factor == working: no precision cut (the f32/c64 pairs on the
        CPU and on CUDA)."""
        return self.factor == self.working

    def factor_cast(self, x: torch.Tensor) -> torch.Tensor:
        """Cast a tensor to the factor dtype ("bfloat16" is
        ``torch.bfloat16``)."""
        return x.to(getattr(torch, self.factor))


def select(
    working,
    n: int,
    opts: Optional[Options] = None,
    method_default: RefineMethod = RefineMethod.Auto,
    backend: Optional[str] = None,
) -> Policy:
    """Resolve the full policy for one solve: the precision pair for
    ``working`` on ``backend`` (the mixed solvers pass the operand's device
    type) plus the Option-routed knobs.  ``method_default`` lets the
    ``*_mixed_gmres`` drivers force GMRES while still honoring an
    explicit ``Option.RefineMethod``."""
    wname = _dtype_name(working)
    lo = factor_dtype(working, backend)
    method = get_option(opts, Option.RefineMethod, None)
    if method is None or method is RefineMethod.Auto or method == "auto":
        method = method_default
    if isinstance(method, str):
        method = RefineMethod.from_string(method)
    if method is RefineMethod.Auto:
        method = RefineMethod.IR
    max_it = int(get_option(opts, Option.MaxIterations, 30))
    tol = get_option(opts, Option.Tolerance, None)
    if tol is None:
        tol = default_tolerance(working, n)
    return Policy(
        working=wname,
        factor=lo if isinstance(lo, str) else np.dtype(lo).name,
        residual=wname,
        method=method.value,
        max_iterations=max_it,
        tolerance=float(tol),
        use_fallback=bool(get_option(opts, Option.UseFallbackSolver, True)),
    )
