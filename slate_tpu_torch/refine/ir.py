"""Classical iterative refinement core, the port of the JAX package's
``refine/ir.py`` (reference: the IR loop of src/gesv_mixed.cc:90-160;
Carson & Higham SISC 2018 for the three-precision convergence analysis
the stopping test follows).

PyTorch runs eagerly, so the JAX package's ``lax.while_loop`` becomes a
Python ``while`` with one host read of ``berr <= tol`` a step; every
other value stays on the operand's device.

Stopping test: the **componentwise backward error** (Oettli–Prager;
Carson & Higham eq. (1.2))

    berr = max_ij |B - A X|_ij / (|A| |X| + |B|)_ij

which, unlike the normwise test the reference uses, certifies the
solution column-by-column and is scale-invariant per entry.  Both the
residual and the denominator are evaluated in the working precision
with full-precision products (``internal.precision.hdot``, TF32 off).
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple, Tuple

import torch

from ..internal.precision import hdot


class RefineResult(NamedTuple):
    """Refinement outcome."""

    X: torch.Tensor  # working-precision solution estimate
    iters: int  # count of correction steps taken
    converged: bool  # berr <= tol before the budget ran out (or at the recheck)
    berr: torch.Tensor  # final componentwise backward error (real 0-d tensor)


def residual_berr(A2: torch.Tensor, X: torch.Tensor, B2: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, berr): the working-precision residual B - A X and its
    componentwise backward error max |R| / (|A||X| + |B|).  The single
    definition of the stopping test — ir and gmres call it, so the two
    methods cannot drift apart on what "converged" means.  An
    exactly-zero denominator entry (identity padding, zero RHS columns)
    means that entry's residual is exactly zero too, so it contributes
    0, not 0/0 — guarded with a where, NOT an absolute floor (a float
    floor underflows to 0.0 in float32 working precision and would NaN
    every float32 solve with a zero row)."""
    R = B2 - hdot(A2, X)
    denom = hdot(A2.abs(), X.abs()) + B2.abs()
    zero = denom == 0
    ratio = torch.where(zero, 0, R.abs() / torch.where(zero, 1, denom))
    return R, ratio.max()


def backward_error(A2: torch.Tensor, X: torch.Tensor, B2: torch.Tensor) -> torch.Tensor:
    """Componentwise (Oettli–Prager) backward error of X; see
    :func:`residual_berr`."""
    return residual_berr(A2, X, B2)[1]


def refine_while(
    A2: torch.Tensor,
    B2: torch.Tensor,
    solve_factor: Callable[[torch.Tensor], torch.Tensor],
    tol: float,
    max_it: int,
) -> RefineResult:
    """Classical IR: ``X <- X + solve_factor(B - A X)`` until the
    componentwise backward error drops below ``tol`` or ``max_it``
    correction steps are spent.

    ``solve_factor`` applies the low-precision factors (cast in, solve,
    cast back to working precision).  A run that passes the test on the
    first residual check reports ``iters == 0``; a stalled or diverging
    run reports ``converged == False`` with the last (possibly
    non-finite) berr — the caller owns the fallback decision."""
    X = solve_factor(B2)
    iters, converged = 0, False
    berr = torch.full((), float("inf"), dtype=B2.abs().dtype, device=B2.device)
    while not converged and iters < max_it:
        R, berr = residual_berr(A2, X, B2)
        converged = bool(berr <= tol)  # the one host read a step
        if not converged:
            X = X + solve_factor(R)
            iters += 1
    # a budget-exhausted loop exits with the berr of its LAST CHECK, one
    # correction behind X — recheck so `converged` never under-reports;
    # the converged exit pays nothing more
    final_berr = berr if converged else backward_error(A2, X, B2)
    return RefineResult(X=X, iters=iters,
                        converged=converged or bool(final_berr <= tol), berr=final_berr)


def ir_refine_while(A2, B2, solve_lo, tol, anorm, max_it
                    ) -> Tuple[torch.Tensor, int, bool]:
    """Back-compat shim for the pre-refine call sites (drivers/lu.py
    exported this normwise-test loop): same signature, same
    ``(X, iters, converged)`` triple.  NOTE the stopping semantics
    changed with the refine extraction: ``tol`` now bounds the
    componentwise backward error ``max |R| / (|A||X| + |B|)``, not the
    old normwise ``|R|max <= tol * anorm * |X|max`` (``anorm`` is kept
    for signature parity and ignored).  A DeprecationWarning fires so the
    semantic change is visible at the call site."""
    warnings.warn(
        "ir_refine_while now stops on the componentwise backward error "
        "(anorm is ignored); migrate to refine.ir.refine_while and "
        "calibrate tol for the componentwise test",
        DeprecationWarning,
        stacklevel=2,
    )
    del anorm
    res = refine_while(A2, B2, solve_lo, tol, max_it)
    return res.X, res.iters, res.converged
