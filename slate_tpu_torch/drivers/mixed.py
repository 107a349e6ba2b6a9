"""Mixed-precision solve drivers (reference: src/gesv_mixed.cc,
gesv_mixed_gmres.cc, posv_mixed.cc, posv_mixed_gmres.cc), the port of
the JAX package's ``drivers/mixed.py``, routed through
:mod:`slate_tpu_torch.refine`.

The shape shared by all four drivers:

1. **Factor once in the cheap precision** (``refine.policy`` picks the
   pair by the operand's device: f32/c64 for f64/c128 working, the
   float32 pair degenerate on the CPU and on CUDA).  The factor step
   reuses the schedule-dispatched factorizations behind ``getrf`` /
   ``potrf`` (``ops/lu_kernels.lu_global``, ``ops/chol_kernels.cholesky``),
   so ``Option.Schedule`` routes the low-precision factor exactly like
   the full-precision one: on a CUDA device at n >= 2048 ``auto`` takes
   the Hopper kernels (chol_base, syrk_diag, gemm_sub; panel_lu) in
   float32.
2. **Refine in working precision**: classical IR
   (:func:`refine.ir.refine_while`) or restarted GMRES-IR
   (:func:`refine.gmres.gmres_refine`), per ``Option.RefineMethod``;
   componentwise-backward-error stopping, full-precision residual
   products.  The factors' triangular solves are the library's
   ``solve_triangular``, as the JAX package's are XLA's.
3. **Fallback**: on non-convergence (or an injected factor fault) and
   ``Option.UseFallbackSolver`` (default True), demote to one
   full-precision direct solve and report ``iters < 0``
   (gesv_mixed_gmres.cc:100-106).  With the fallback disabled, a
   non-converged solve returns ``info > 0`` — never silent garbage.

Returns follow the reference: ``(X, info, iters)`` with ``iters < 0``
marking the fallback; ``info`` is an int32 tensor on X's device.  The
serve tier's core is :func:`serve_mixed_core`, which has no fallback
inside and NaN-poisons a solve that does not converge.

Fault sites (``aux/faults``, one bool check when off): the *factor
step* checks ``result_corrupt`` (NaN-poisons the low-precision factor)
and ``info_nonzero`` (reports a fake nonzero factor info) — both drive
the refinement into the fallback path.

Metrics: ``refine.calls`` / ``refine.iterations`` /
``refine.converged`` / ``refine.fallbacks`` counters plus the
``refine.residual`` gauge (final componentwise backward error), global
and per-routine (``refine.gesv_mixed.*`` etc.).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..aux import faults, metrics, spans
from ..aux.metrics import instrumented
from ..enums import Option, RefineMethod
from ..matrix.base import single_device
from ..matrix.matrix import HermitianMatrix, Matrix
from ..ops import chol_kernels, lu_kernels
from ..options import Options, resolve_schedule_opts
from ..parallel.layout import tiles_from_global
from ..refine import gmres as _gmres
from ..refine import ir as _ir
from ..refine import policy as _policy

_solve_tri = torch.linalg.solve_triangular


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _record(routine: str, iters: int, converged: bool, berr: float) -> None:
    if spans.is_on():
        # the iteration count rides on the span the caller is inside; with
        # no enclosing span, a `refine` instant carries it
        if spans.current() is not None:
            spans.annotate(refine_iters=int(iters), refine_converged=bool(converged))
        else:
            spans.event("refine", routine=routine, refine_iters=int(iters),
                        refine_converged=bool(converged))
    if not metrics.is_on():
        return
    for name in ("refine", f"refine.{routine}"):
        metrics.inc(f"{name}.calls")
        metrics.inc(f"{name}.iterations", iters)
        if converged:
            metrics.inc(f"{name}.converged")
        metrics.gauge(f"{name}.residual", berr)


def _record_fallback(routine: str) -> None:
    metrics.inc("refine.fallbacks")
    metrics.inc(f"refine.{routine}.fallbacks")
    if spans.is_on():
        if spans.current() is not None:
            spans.annotate(refine_fallback=True)
        else:
            spans.event("refine_fallback", routine=routine)


# ---------------------------------------------------------------------------
# low-precision factor step (schedule-routed, fault-checked)
# ---------------------------------------------------------------------------


def _inject_factor_faults(factor: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Factor-step fault sites (eager drivers only; one bool when off):
    ``result_corrupt`` NaN-poisons the factor, ``info_nonzero`` reports
    a fake nonzero factor info.  Either way the refinement loop sees a
    useless factor and the fallback solver is exercised."""
    if not faults.is_on():
        return factor, 0
    factor = faults.corrupt("result_corrupt", factor)
    finfo = int(faults.poison_info("info_nonzero", torch.zeros(1, dtype=torch.int32))[0])
    return factor, finfo


def _pad_unit_diag(G: torch.Tensor, npad: int) -> torch.Tensor:
    """Embed G in the top-left of an npad x npad tensor with a unit
    trailing diagonal (blockdiag(A, I): factors restrict exactly, pad
    rows are never pivoted into real columns)."""
    n = G.shape[0]
    if npad == n:
        return G
    Gp = torch.nn.functional.pad(G, (0, npad - n, 0, npad - n))
    idx = torch.arange(n, npad, device=G.device)
    Gp[idx, idx] = 1
    return Gp


def _lu_solver_lo(A2: torch.Tensor, pol: _policy.Policy, nb: int,
                  opts: Optional[Options], inject: bool, apply_up: bool = False):
    """Low-precision LU factor of A2 + the solve closure.  Returns
    (solve, factor_info).

    ``apply_up=False`` (classical IR) casts the residual down and
    solves in the factor precision — gesv_mixed.cc semantics, the
    cheapest correction step.  ``apply_up=True`` (GMRES-IR) upcasts
    the factors once and applies them in the working precision: the
    Krylov matvec must see the preconditioned operator exactly in
    precision u (Carson & Higham SISC 2018) — an eps_factor-perturbed
    operator stalls GMRES at berr ~ eps_factor, no better than IR."""
    sched, nb_switch, lookahead = resolve_schedule_opts(opts)
    n = A2.shape[0]
    nb = max(min(int(nb), n), 1)
    npad = -(-n // nb) * nb
    Gp = _pad_unit_diag(pol.factor_cast(A2), npad)
    lu_lo, perm = lu_kernels.lu_global(Gp, nb, sched, nb_switch, lookahead)
    finfo = 0
    if inject:
        lu_lo, finfo = _inject_factor_faults(lu_lo)
    lu_lo = lu_lo[:n, :n]
    perm = perm[:n].long()
    fac = lu_lo.to(A2.dtype) if apply_up else lu_lo

    def solve(R):
        Rp = (R if apply_up else pol.factor_cast(R))[perm]
        Y = _solve_tri(fac, Rp, upper=False, unitriangular=True)
        return _solve_tri(fac, Y, upper=True).to(R.dtype)

    return solve, finfo


def _chol_solver_lo(A_full: torch.Tensor, pol: _policy.Policy, nb: int,
                    opts: Optional[Options], conj: bool, inject: bool,
                    apply_up: bool = False):
    """Low-precision Cholesky of the (full, Hermitian) A + the solve
    closure.  Returns (solve, factor_info).  ``apply_up`` as in
    :func:`_lu_solver_lo`: GMRES-IR applies the upcast factors in the
    working precision."""
    sched, nb_switch, lookahead = resolve_schedule_opts(opts)
    n = A_full.shape[0]
    nb_kernel = 512 if n >= 2048 else max(min(int(nb), 512), 1)
    L_lo = chol_kernels.cholesky(pol.factor_cast(A_full), nb_kernel, sched, nb_switch,
                                 lookahead)
    finfo = 0
    if inject:
        L_lo, finfo = _inject_factor_faults(L_lo)
    fac = L_lo.to(A_full.dtype) if apply_up else L_lo
    facT = fac.mH if conj else fac.mT

    def solve(R):
        Y = _solve_tri(fac, R if apply_up else pol.factor_cast(R), upper=False)
        return _solve_tri(facT, Y, upper=True).to(R.dtype)

    return solve, finfo


# ---------------------------------------------------------------------------
# full-precision fallback solves
# ---------------------------------------------------------------------------


def _full_lu_solve(A2: torch.Tensor, B2: torch.Tensor) -> torch.Tensor:
    """The library LU and its solve (``lu_kernels.lu_supported`` holds
    for every dtype in the port)."""
    LU, piv, _ = torch.linalg.lu_factor_ex(A2)
    return torch.linalg.lu_solve(LU, piv, B2)


def _full_chol_solve(A_full: torch.Tensor, B2: torch.Tensor, conj: bool) -> torch.Tensor:
    Lw = chol_kernels.cholesky(A_full)
    Y = _solve_tri(Lw, B2, upper=False)
    return _solve_tri(Lw.mH if conj else Lw.mT, Y, upper=True)


# ---------------------------------------------------------------------------
# refinement dispatch (shared by all four drivers)
# ---------------------------------------------------------------------------


def _gmres_selected(pol: _policy.Policy) -> bool:
    """True when the resolved method is GMRES-IR, which needs the
    preconditioner applied in working precision (``apply_up``)."""
    return pol.method == RefineMethod.GMRES.value


def _refine(A2, B2, solve_lo, pol: _policy.Policy):
    """Run the policy's method; returns (X, iters, steps, converged,
    berr).  ``iters`` keeps the reference's reporting unit (IR steps,
    or GMRES *inner* iterations = cycles * restart); ``steps`` is the
    method-independent refinement-step count (one GMRES cycle == one
    step) that feeds the iterations counter."""
    if _gmres_selected(pol):
        # one GMRES(restart) cycle is one refinement step, so the
        # outer-cycle budget is MaxIterations
        res = _gmres.gmres_refine(A2, B2, solve_lo, pol.tolerance, pol.restart,
                                  max(1, pol.max_iterations))
        return res.X, res.cycles * pol.restart, res.cycles, res.converged, res.berr
    res = _ir.refine_while(A2, B2, solve_lo, pol.tolerance, pol.max_iterations)
    return res.X, res.iters, res.iters, res.converged, res.berr


def _finish(routine: str, B: Matrix, X: torch.Tensor, iters: int, steps: int,
            conv: bool, berr: torch.Tensor, finfo: int, pol: _policy.Policy,
            fallback_solve) -> Tuple[Matrix, torch.Tensor, int]:
    """Host-side epilogue: metrics, fallback, info."""
    converged = conv and finfo == 0
    _record(routine, steps, converged, float(berr.real))
    info = 0
    if not converged:
        if pol.use_fallback:
            _record_fallback(routine)
            X = fallback_solve()
            iters = -max(pol.max_iterations, 1)
        else:
            # no fallback requested: a non-converged solve must surface
            # as a nonzero info, never as silently-wrong finite output
            info = max(finfo, pol.max_iterations, 1)
    info = torch.where(torch.isfinite(X).all(), info, 1).to(torch.int32)
    Xm = B._with(data=tiles_from_global(X.to(B.dtype), B.layout))
    return Xm, info, iters


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def _gesv_like(routine: str, A: Matrix, B: Matrix, opts: Optional[Options],
               method_default: RefineMethod):
    A2 = A.to_global()
    B2 = B.to_global()
    pol = _policy.select(A2.dtype, A.n, opts, method_default, backend=A2.device.type)
    solve_lo, finfo = _lu_solver_lo(A2, pol, A.layout.nb, opts, inject=True,
                                    apply_up=_gmres_selected(pol))
    X, iters, steps, conv, berr = _refine(A2, B2, solve_lo, pol)
    return _finish(routine, B, X, iters, steps, conv, berr, finfo, pol,
                   lambda: _full_lu_solve(A2, B2))


def _posv_like(routine: str, A: HermitianMatrix, B: Matrix, opts: Optional[Options],
               method_default: RefineMethod):
    A_full = A.full_global()
    B2 = B.to_global()
    pol = _policy.select(A_full.dtype, A.n, opts, method_default,
                         backend=A_full.device.type)
    solve_lo, finfo = _chol_solver_lo(A_full, pol, A.layout.nb, opts, A.is_complex,
                                      inject=True, apply_up=_gmres_selected(pol))
    X, iters, steps, conv, berr = _refine(A_full, B2, solve_lo, pol)
    return _finish(routine, B, X, iters, steps, conv, berr, finfo, pol,
                   lambda: _full_chol_solve(A_full, B2, A.is_complex))


@instrumented("gesv_mixed")
@single_device("8b2")
def gesv_mixed(A: Matrix, B: Matrix, opts: Optional[Options] = None
               ) -> Tuple[Matrix, torch.Tensor, int]:
    """Mixed-precision LU solve with iterative refinement (reference:
    src/gesv_mixed.cc: low-precision factor + working-precision IR).

    Returns (X, info, iters); iters < 0 => full-precision fallback ran."""
    return _gesv_like("gesv_mixed", A, B, opts, RefineMethod.Auto)


@instrumented("gesv_mixed_gmres")
@single_device("8b2")
def gesv_mixed_gmres(A: Matrix, B: Matrix, opts: Optional[Options] = None
                     ) -> Tuple[Matrix, torch.Tensor, int]:
    """Mixed-precision solve with restarted GMRES-IR, LU preconditioner
    in low precision (reference: src/gesv_mixed_gmres.cc: restart 30,
    fallback on divergence).  Survives ~1/eps_factor more
    ill-conditioning than gesv_mixed (Carson & Higham SISC 2018)."""
    return _gesv_like("gesv_mixed_gmres", A, B, opts, RefineMethod.GMRES)


@instrumented("posv_mixed")
@single_device("8b2")
def posv_mixed(A: HermitianMatrix, B: Matrix, opts: Optional[Options] = None
               ) -> Tuple[Matrix, torch.Tensor, int]:
    """Mixed-precision SPD solve: low-precision Cholesky + working-
    precision IR (reference: src/posv_mixed.cc)."""
    return _posv_like("posv_mixed", A, B, opts, RefineMethod.Auto)


@instrumented("posv_mixed_gmres")
@single_device("8b2")
def posv_mixed_gmres(A: HermitianMatrix, B: Matrix, opts: Optional[Options] = None
                     ) -> Tuple[Matrix, torch.Tensor, int]:
    """Mixed-precision SPD solve with GMRES-IR, low-precision Cholesky
    preconditioner (reference: src/posv_mixed_gmres.cc — shares the
    GMRES-IR core with the LU variant)."""
    return _posv_like("posv_mixed_gmres", A, B, opts, RefineMethod.GMRES)


# ---------------------------------------------------------------------------
# serving-layer core
# ---------------------------------------------------------------------------


def serve_mixed_core(routine: str, Ag: torch.Tensor, Bg: torch.Tensor, nb: int,
                     schedule: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixed-precision core for one serve bucket
    (``BucketKey(precision="mixed")``, ROADMAP.md Queue 1 item 4):
    classical IR only, no fallback *inside*.  A solve that does not
    converge returns X poisoned with NaN: the service's corrupt-result
    validation then re-solves it on the full-precision direct driver and
    records a breaker failure, so recovery stays in the serving layer.

    ``posv`` references only the lower triangle of ``Ag`` (the serve
    contract) — the Hermitian full matrix is rebuilt for the residual."""
    opts = {Option.Schedule: schedule}
    if routine == "posv":
        # strictly-upper = conj of strictly-lower; the stored diagonal is
        # kept exactly (the direct posv core's Hermitian contract)
        A2 = torch.tril(Ag) + torch.tril(Ag, -1).mH
        pol = _policy.select(Ag.dtype, Ag.shape[0], opts, backend=Ag.device.type)
        solve_lo, _ = _chol_solver_lo(A2, pol, nb, opts, Ag.is_complex(), inject=False)
    elif routine == "gesv":
        A2 = Ag
        pol = _policy.select(Ag.dtype, Ag.shape[0], opts, backend=Ag.device.type)
        solve_lo, _ = _lu_solver_lo(A2, pol, nb, opts, inject=False)
    else:
        raise ValueError(f"mixed-precision serving supports gesv/posv, not {routine!r}")
    res = _ir.refine_while(A2, Bg, solve_lo, pol.tolerance, pol.max_iterations)
    X = res.X if res.converged else torch.full_like(res.X, float("nan"))
    return X, torch.zeros((), dtype=torch.int32, device=X.device)
