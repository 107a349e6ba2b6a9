"""Hager/Higham 1-norm estimator (reference: src/internal/
internal_norm1est.cc:1-511, used by gecondest/pocondest/trcondest), the
counterpart of the JAX package's ``internal/norm1est.py``.

Estimates ||B||_1 for an implicitly given B (for example A^-1 through
factor solves) with a handful of solves instead of an explicit O(n^3)
inverse: Higham's algorithm 4.1 (the LAPACK xLACON iteration).  Each
iteration is one B-apply and one B^H-apply, both O(n^2) triangular
solves on the operand's device.  The JAX package runs the iteration as a
``lax.while_loop``; here it is a Python loop of at most ``max_iter``
iterations whose stopping test reads one flag back to the host an
iteration.  ``rcond`` turns the estimate of an inverse's norm into the
reciprocal condition number of the condition estimators.
"""

from __future__ import annotations

from typing import Callable

import torch


def norm1est(apply_b: Callable, apply_bh: Callable, n: int, dtype, max_iter: int = 5, *,
             device) -> torch.Tensor:
    """Estimate ||B||_1 given x -> B x and x -> B^H x (column vectors),
    as a real 0-d tensor on ``device``.

    Starts from the uniform vector and alternates B / B^H applies toward
    a maximizing unit column (the first largest |z|, as ``argmax``
    picks), stopping when the estimate no longer grows or the column
    repeats; the alternating-sign vector (-1)^i (1 + i/(n-1)) guards
    against underestimates on special structures."""
    cplx = dtype.is_complex
    real_t = torch.empty((), dtype=dtype).real.dtype if cplx else dtype

    def csign(y):
        if cplx:
            a = y.abs()
            return torch.where(a == 0, torch.ones_like(y), y / torch.where(a == 0, 1, a))
        return torch.where(y >= 0, 1.0, -1.0).to(dtype)

    x = torch.full((n, 1), 1.0 / n, dtype=dtype, device=device)
    y = apply_b(x)
    est = y.abs().sum().to(real_t)
    est_old = torch.tensor(-1.0, dtype=real_t, device=device)
    j, j_old = torch.tensor(-1, device=device), torch.tensor(-2, device=device)
    for _ in range(max_iter):
        if not bool((est > est_old) & (j != j_old)):
            break
        z = apply_bh(csign(y))
        j, j_old = torch.argmax(z.abs().reshape(-1)), j
        x = torch.zeros((n, 1), dtype=dtype, device=device)
        x[j, 0] = 1.0
        y = apply_b(x)
        est, est_old = torch.maximum(y.abs().sum().to(real_t), est), est
    # alternating-sign safeguard (Higham 4.1 final test)
    i = torch.arange(n, dtype=real_t, device=device)
    b = ((-1.0) ** i * (1.0 + i / max(n - 1, 1))).to(dtype)[:, None]
    alt = 2.0 * apply_b(b).abs().sum().to(real_t) / (3.0 * n)
    return torch.maximum(est, alt)


def rcond(anorm, solve: Callable, solve_h: Callable, n: int, dtype, inf: bool = False, *,
          device) -> torch.Tensor:
    """1 / (anorm ||A^-1||), 0 where that is not finite, given x -> A^-1 x
    and x -> A^-H x: ||A^-1||_1 from ``norm1est``, ||A^-1||_inf
    (``inf``) as ||A^-H||_1.  A Python or numpy ``anorm`` stays a weak
    scalar: it does not round to the default dtype."""
    est = norm1est(solve_h, solve, n, dtype, device=device) if inf else \
        norm1est(solve, solve_h, n, dtype, device=device)
    anorm = anorm.to(device) if torch.is_tensor(anorm) else float(anorm)
    r = 1.0 / (anorm * est)
    return torch.where(torch.isfinite(r), r, torch.zeros_like(r))
