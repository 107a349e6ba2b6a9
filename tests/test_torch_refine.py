"""Port parity: the mixed-precision solvers of slate_tpu_torch — the
``refine`` subsystem (policy, IR, GMRES-IR) and ``drivers/mixed.py`` —
against the JAX package on the CPU, and the non-serve checks of
tests/test_refine.py on the port.

The same numpy operands (``matgen.cond_matrix``, seeded normal right
sides) go through both packages.  Tolerances: X within ``50 n eps64
max|ref|`` of the JAX package's at cond 1e3 (the two float32 factors
differ by rounding, which the refinement takes down to eps64 times the
condition number); ``backward_error`` within 1e-14 relative; the
LAPACK-style residual bounds of tests/test_refine.py.  ``iters`` equal
to the JAX package's for IR; for GMRES-IR the cycle counts equal, or one
apart with both runs converged (one cycle is ``GMRES_RESTART`` inner
iterations, and at cond 1e9 a rounding difference can decide whether a
second cycle is needed)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu.drivers import mixed as jmixed
from slate_tpu.matgen import cond_matrix as _jcond
from slate_tpu.refine import ir as jir
from slate_tpu.testing import checks
from slate_tpu_torch.aux import faults, metrics, spans
from slate_tpu_torch.drivers import mixed as tmixed
from slate_tpu_torch.enums import Option, RefineMethod
from slate_tpu_torch.matgen import cond_matrix
from slate_tpu_torch.ops.hopper import panel_kernels as pk
from slate_tpu_torch.refine import gmres as tgmres
from slate_tpu_torch.refine import ir as tir
from slate_tpu_torch.refine import policy

torch.set_num_threads(1)

CPU = stt.ProcessGrid.single("cpu")
EPS64 = float(np.finfo(np.float64).eps)
RESTART = policy.GMRES_RESTART


@pytest.fixture(autouse=True)
def _clean():
    """refine.* counters are part of the contract: collect them for every
    test; leave faults and spans off, and no kernel launched (the CPU
    runs the plain versions)."""
    was_on = metrics.is_on()
    metrics.on()
    pk.reset_launches()
    yield
    if not was_on:
        metrics.off()
    faults.reset()
    spans.off()
    spans.clear()
    assert all(v == 0 for v in pk.LAUNCHES.values()), pk.LAUNCHES


def jcond(*args, **kw):
    """The JAX package's cond_matrix, as a writable array."""
    return np.array(_jcond(*args, **kw))


def _rhs(n, nrhs=2, seed=7):
    return np.random.default_rng(seed).standard_normal((n, nrhs))


def _tol(n, ref):
    return 50 * n * EPS64 * max(float(np.abs(ref).max()), 1.0)


def _mats(pkg, A0, B0, spd, nb=16):
    grid = {} if pkg is st else {"grid": CPU}
    if spd:
        A = pkg.HermitianMatrix.from_global(A0, nb, uplo=pkg.Uplo.Lower, **grid)
    else:
        A = pkg.Matrix.from_global(A0, nb, **grid)
    return A, pkg.Matrix.from_global(B0, nb, **grid)


def _drive(pkg, spd, gmres, A0, B0, opts=None, nb=16):
    name = ("posv" if spd else "gesv") + "_mixed" + ("_gmres" if gmres else "")
    X, info, iters = getattr(pkg, name)(*_mats(pkg, A0, B0, spd, nb), opts)
    X = X.to_global()
    return (X.numpy() if torch.is_tensor(X) else np.asarray(X)), int(info), int(iters)


def _same_iters(it_t, it_j, gmres, both_converged):
    if not gmres or it_t < 0 or it_j < 0:
        assert it_t == it_j
    else:
        assert it_t % RESTART == 0 and it_j % RESTART == 0
        assert it_t == it_j or (both_converged and abs(it_t - it_j) == RESTART)


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,f64,c128,f32,c64", [
    ("cpu", "float32", "complex64", "float32", "complex64"),
    ("tpu", "float32", "complex64", "bfloat16", "complex64"),
    ("cuda", "float32", "complex64", "float32", "complex64"),
])
def test_policy_pairs(backend, f64, c128, f32, c64):
    """The JAX package's CPU and accelerator rows as they are, and the
    CUDA row: float32 working precision degenerate (torch has no
    bfloat16 factorization)."""
    from slate_tpu.refine import policy as jpolicy

    for w, want in ((np.float64, f64), (np.complex128, c128), (np.float32, f32),
                    (np.complex64, c64)):
        got = policy.factor_dtype(w, backend)
        assert (got if isinstance(got, str) else got.name) == want
        if backend != "cuda":
            assert got == jpolicy.factor_dtype(w, backend)
        tw = getattr(torch, np.dtype(w).name)
        assert policy.factor_dtype(tw, backend) == got
    pol = policy.select(torch.float32, 64, backend=backend)
    assert pol.degenerate == (backend != "tpu")
    assert pol.factor_cast(torch.ones(2)).dtype == getattr(torch, pol.factor)


def test_policy_default_backend_is_the_card():
    assert policy.DEFAULT_BACKEND == "cuda"
    assert policy.select(np.float32, 8).degenerate
    assert policy.factor_dtype(np.float64) == np.dtype(np.float32)


def test_policy_option_routing():
    from slate_tpu.refine import policy as jpolicy

    opts_list = [
        None,
        {Option.RefineMethod: "gmres", Option.MaxIterations: 5, Option.Tolerance: 1e-10,
         Option.UseFallbackSolver: False},
        {"refine_method": RefineMethod.IR, "max_iterations": 7},
    ]
    for opts in opts_list:
        for default in (RefineMethod.Auto, RefineMethod.GMRES):
            got = policy.select(np.float64, 64, opts, method_default=default, backend="cpu")
            jopts = None if opts is None else {
                st.Option[k.name] if isinstance(k, Option) else k:
                (st.RefineMethod[v.name] if isinstance(v, RefineMethod) else v)
                for k, v in opts.items()}
            ref = jpolicy.select(np.float64, 64, jopts,
                                 method_default=st.RefineMethod[default.name], backend="cpu")
            assert got.__dict__ == ref.__dict__
    pol = policy.select(np.float64, 64)
    assert pol.method == "ir" and pol.max_iterations == 30 and pol.use_fallback
    assert pol.tolerance == pytest.approx(8 * EPS64)


@pytest.mark.parametrize("dtype", [np.int32, torch.int64, torch.bfloat16])
def test_policy_unknown_dtype_rejected(dtype):
    with pytest.raises(ValueError):
        policy.factor_dtype(dtype)


# ---------------------------------------------------------------------------
# IR core
# ---------------------------------------------------------------------------


def _berr_cases():
    """Small integers, so the residual and the denominators are exact
    in both packages and the ratio is one correctly rounded division."""
    rng = np.random.default_rng(1)
    A = rng.integers(-5, 6, (32, 32)).astype(np.float64)
    X = rng.integers(-5, 6, (32, 3)).astype(np.float64)
    B = A @ X + rng.integers(-2, 3, (32, 3))
    Xz, Bz = X.copy(), B.copy()
    Xz[:, 1] = Bz[:, 1] = 0  # a zero right side: zero denominators in that column
    Az, Bzr = A.copy(), B.copy()
    Az[5] = Bzr[5] = 0  # a zero row of A and B
    return {"exact": (A, X, A @ X), "perturbed": (A, X, B), "zero_column": (A, Xz, Bz),
            "zero_row": (Az, X, Bzr)}


@pytest.mark.parametrize("case", ["exact", "perturbed", "zero_column", "zero_row"])
def test_backward_error_matches_jax(case):
    A, X, B = _berr_cases()[case]
    ref = float(jir.backward_error(jnp.asarray(A), jnp.asarray(X), jnp.asarray(B)))
    got = float(tir.backward_error(*(torch.from_numpy(a) for a in (A, X, B))))
    assert np.isfinite(got)
    assert abs(got - ref) <= 1e-14 * abs(ref)
    assert (got == 0) == (case == "exact")


@pytest.mark.parametrize("scale,max_it,tol", [(1.0, 10, 1e-14), (0.5, 40, 1e-14),
                                              (0.5, 3, 1e-14), (0.5, 0, 1e-14)],
                         ids=["exact", "contracting", "budget", "no_budget"])
def test_refine_while_counts_steps_like_jax(scale, max_it, tol):
    """A solver that is exact (converges on the first check) or that
    halves the error each step; the budget-exhausted exit rechecks."""
    A = jcond(32, 10.0)
    B = _rhs(32)
    ref = jir.refine_while(jnp.asarray(A), jnp.asarray(B),
                           lambda R: scale * jnp.linalg.solve(jnp.asarray(A), R), tol, max_it)
    At = torch.from_numpy(A)
    got = tir.refine_while(At, torch.from_numpy(B),
                           lambda R: scale * torch.linalg.solve(At, R), tol, max_it)
    assert got.iters == int(ref.iters) and got.converged == bool(ref.converged)
    assert float(got.berr) == pytest.approx(float(ref.berr), rel=1e-6, abs=1e-15)
    np.testing.assert_allclose(got.X.numpy(), np.asarray(ref.X), rtol=0, atol=_tol(32, B))
    if scale == 1.0:
        assert got.converged and got.iters <= 1


def test_ir_refine_while_shim_warns():
    A = torch.from_numpy(jcond(16, 10.0))
    B = torch.from_numpy(_rhs(16))
    with pytest.warns(DeprecationWarning):
        X, iters, conv = stt.drivers.lu.ir_refine_while(
            A, B, lambda R: torch.linalg.solve(A, R), 1e-14, 123.0, 5)
    assert conv and iters <= 1


@pytest.mark.parametrize("case", ["random", "zero", "rank_deficient", "happy_breakdown", "nan"])
def test_lstsq_min_norm_matches_jnp(case):
    """The GMRES small least squares: jnp.linalg.lstsq's SVD solution
    with its rcond, batched over columns."""
    rng = np.random.default_rng(3)
    H = np.triu(rng.standard_normal((31, 30)), -1)
    b = np.zeros(31)
    b[0] = 2.5
    if case == "zero":
        H[:] = 0
        b[:] = 0
    elif case == "rank_deficient":
        H[:, 7] = H[:, 3]
    elif case == "happy_breakdown":
        H[11, 10] = 0  # the Krylov space closes at step 10
        H[:, 11:] = 0
    elif case == "nan":
        H[4, 4] = np.nan
    ref = np.asarray(jnp.linalg.lstsq(jnp.asarray(H), jnp.asarray(b))[0])
    got = tgmres.lstsq_min_norm(torch.from_numpy(H)[None], torch.from_numpy(b)[None])[0].numpy()
    if case == "nan":
        assert np.isnan(got).all() and np.isnan(ref).all()
        return
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * max(np.abs(ref).max(), 1.0))


# ---------------------------------------------------------------------------
# drivers: parity, iteration bounds, fallback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["auto", "pallas"])
@pytest.mark.parametrize("gmres", [False, True], ids=["ir", "gmres"])
@pytest.mark.parametrize("spd", [False, True], ids=["gesv", "posv"])
def test_mixed_drivers_match_jax(spd, gmres, schedule):
    """n = 64, cond 1e3, tiles of 16: the port's X within 50 n eps
    max|ref| of the JAX package's (its pallas schedule in interpret
    mode), iters equal."""
    n = 64
    A0, B0 = jcond(n, 1e3, spd=spd), _rhs(n, 3)
    opts = {"schedule": schedule}
    Xj, info_j, it_j = _drive(st, spd, gmres, A0, B0, opts)
    Xt, info_t, it_t = _drive(stt, spd, gmres, A0, B0, opts)
    assert info_t == info_j == 0 and it_t >= 0
    _same_iters(it_t, it_j, gmres, True)
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=_tol(n, Xj))
    assert checks.solve_residual(A0, Xt, B0) < 50 * EPS64


@pytest.mark.parametrize("spd", [False, True], ids=["gesv", "posv"])
def test_mixed_converges_within_8_iters_at_cond_1e4(spd):
    n = 96
    A0 = cond_matrix(n, 1e4, spd=spd, device="cpu")
    B0 = _rhs(n, 2)
    X, info, iters = _drive(stt, spd, False, A0, B0, nb=32)
    assert info == 0
    assert 0 <= iters <= 8, iters
    assert checks.solve_residual(A0, X, B0) < 50 * EPS64


@pytest.mark.parametrize("spd", [False, True], ids=["gesv", "posv"])
def test_mixed_divergence_falls_back(spd):
    n = 64
    A0 = cond_matrix(n, 1e9, spd=spd, device="cpu")  # cond * eps_f32 ~ 1e2
    B0 = _rhs(n)
    with metrics.deltas() as d:
        X, info, iters = _drive(stt, spd, False, A0, B0)
    assert iters < 0 and info == 0  # the fallback solver ran, and is usable
    assert d.get("refine.fallbacks") == 1
    assert d.get(f"refine.{'posv' if spd else 'gesv'}_mixed.fallbacks") == 1
    assert np.all(np.isfinite(X))
    assert checks.solve_residual(A0, X, B0) < 100 * EPS64
    Xj, info_j, it_j = _drive(st, spd, False, A0, B0)
    assert (it_j, info_j) == (iters, info)


def test_gesv_mixed_no_fallback_is_typed_not_garbage():
    n = 64
    A0, B0 = cond_matrix(n, 1e9, device="cpu"), _rhs(n)
    opts = {Option.UseFallbackSolver: False}
    X, info, iters = _drive(stt, False, False, A0, B0, opts)
    assert info != 0 and iters >= 0  # non-convergence surfaces as nonzero info
    A, B = _mats(stt, A0, B0, False)
    with pytest.raises(stt.NumericalError):
        stt.simplified.solve_mixed(A, B, opts)
    # with the fallback on, the verb returns the full-precision solve
    Xs = stt.simplified.solve_mixed(A, B).to_global().numpy()
    assert checks.solve_residual(A0, Xs, B0) < 100 * EPS64


def test_gmres_ir_converges_where_classical_ir_stalls():
    n = 64
    A0, B0 = cond_matrix(n, 1e9, device="cpu"), _rhs(n)
    opts = {Option.UseFallbackSolver: False}
    _X, info_ir, _ = _drive(stt, False, False, A0, B0, opts)
    assert info_ir != 0  # classical IR stalls at cond ~ 1/eps_f32 ...
    Xg, info_g, iters_g = _drive(stt, False, True, A0, B0, opts)
    assert info_g == 0 and iters_g > 0  # ... GMRES-IR converges
    ref = np.linalg.solve(A0, B0)
    assert np.abs(Xg - ref).max() / np.abs(ref).max() < 1e-6
    Xj, info_j, it_j = _drive(st, False, True, A0, B0, opts)
    _same_iters(iters_g, it_j, True, info_j == 0)


def _outliers(solve, A0):
    """Eigenvalues of the preconditioned operator U^-1 L^-1 P A farther
    than 1/2 from 1: one GMRES(restart) cycle resolves at most
    ``restart`` of them."""
    S = solve(A0)
    return int((np.abs(np.linalg.eigvals(np.asarray(S)) - 1) > 0.5).sum())


@pytest.mark.parametrize("n", [128, 512])
def test_gmres_ir_reach_at_cond_1e9_matches_jax(n):
    """GMRES-IR's reach at cond 1e9 grows with n no further than
    GMRES(30) allows, in both packages alike: the float32 LU leaves
    about n/6 eigenvalues of the preconditioned operator away from 1.
    At n = 128 (fewer than 30 such eigenvalues) both converge without
    the fallback; at n = 512 (more than 30) both stall for all 30 cycles
    and fall back (iters == -30), their last backward errors far above
    the tolerance and of one order of magnitude (the stalled value
    depends on the float32 factor's rounding, which differs)."""
    from slate_tpu.aux import metrics as jmetrics
    from slate_tpu.refine import policy as jpolicy

    A0, B0 = jcond(n, 1e9), _rhs(n)
    js, _ = jmixed._lu_solver_lo(jnp.asarray(A0), jpolicy.select(np.float64, n), 64, None,
                                 False, True)
    ts, _ = tmixed._lu_solver_lo(torch.from_numpy(A0), policy.select(torch.float64, n,
                                 backend="cpu"), 64, None, False, True)
    out_j, out_t = _outliers(lambda A: js(jnp.asarray(A)), A0), \
        _outliers(lambda A: ts(torch.from_numpy(A)).numpy(), A0)
    jwas_on = jmetrics.is_on()
    jmetrics.on()
    try:
        Xj, info_j, it_j = _drive(st, False, True, A0, B0, nb=64)
        berr_j = jmetrics.gauges()["refine.residual"]
    finally:
        if not jwas_on:
            jmetrics.off()
    Xt, info_t, it_t = _drive(stt, False, True, A0, B0, nb=64)
    berr_t = metrics.gauges()["refine.residual"]
    assert info_t == info_j == 0
    tol = policy.default_tolerance(np.float64, n)
    if n == 128:
        assert out_t < RESTART and out_j < RESTART
        assert it_t > 0 and it_j > 0 and berr_t <= tol and berr_j <= tol
        _same_iters(it_t, it_j, True, True)
    else:
        assert out_t > RESTART and out_j > RESTART
        assert it_t == it_j == -30
        assert berr_t > 1e4 * tol and berr_j > 1e4 * tol
        assert 0.1 < berr_t / berr_j < 10
    for X in (Xt, Xj):
        assert checks.solve_residual(A0, X, B0) < 100 * EPS64


def test_gmres_zero_rhs_column_matches_jax():
    """An all-zero right side gives an all-zero Hessenberg block in the
    GMRES cycle: its least squares returns 0 there, as jnp.linalg.lstsq
    does, and the column stays exactly zero."""
    n = 48
    A0 = jcond(n, 1e6)
    B0 = _rhs(n, 3)
    B0[:, 1] = 0
    Xj, info_j, it_j = _drive(st, False, True, A0, B0)
    Xt, info_t, it_t = _drive(stt, False, True, A0, B0)
    assert info_t == info_j == 0 and it_t > 0
    _same_iters(it_t, it_j, True, True)
    assert (Xt[:, 1] == 0).all() and (Xj[:, 1] == 0).all()
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=1e-9 * np.abs(Xj).max())


def test_mixed_complex_parity():
    rng = np.random.default_rng(5)
    n = 32
    A0 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)) + n * np.eye(n)
    B0 = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    S0 = A0 @ A0.conj().T + n * np.eye(n)
    for spd, gmres, M in ((False, False, A0), (True, True, S0)):
        Xt, info, iters = _drive(stt, spd, gmres, M, B0)
        assert info == 0 and iters >= 0
        assert checks.solve_residual(M, Xt, B0) < 50 * EPS64
        Xj, _, it_j = _drive(st, spd, gmres, M, B0)
        _same_iters(iters, it_j, gmres, True)
        np.testing.assert_allclose(Xt, Xj, rtol=0, atol=_tol(n, Xj))


def test_float32_working_is_the_degenerate_pair():
    n = 48
    A0 = cond_matrix(n, 10.0, np.float32, device="cpu")
    B0 = _rhs(n).astype(np.float32)
    X, info, iters = _drive(stt, False, False, A0, B0)
    assert info == 0 and 0 <= iters <= 1 and X.dtype == np.float32
    assert checks.solve_residual(A0, X, B0) < 50 * np.finfo(np.float32).eps


def test_refine_metrics_recorded():
    n = 64
    A0, B0 = cond_matrix(n, 1e3, device="cpu"), _rhs(n)
    with metrics.deltas() as d:
        _drive(stt, False, False, A0, B0)
    assert d.get("refine.calls") == 1
    assert d.get("refine.gesv_mixed.calls") == 1
    assert d.get("refine.converged") == 1
    assert d.get("refine.iterations") >= 1
    assert d.get("gesv_mixed.calls") == 1
    assert metrics.gauges().get("refine.residual") is not None
    assert {k for k in d.all() if k.startswith("refine.")} >= {
        "refine.calls", "refine.converged", "refine.iterations"}


# ---------------------------------------------------------------------------
# factor-step fault injection -> fallback solver; spans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("site,spd", [("info_nonzero", False), ("result_corrupt", True)])
def test_factor_fault_exercises_fallback(site, spd):
    n = 48
    A0, B0 = cond_matrix(n, 10.0, spd=spd, device="cpu"), _rhs(n)
    faults.arm(site, once=True)
    faults.on()
    with metrics.deltas() as d:
        X, info, iters = _drive(stt, spd, False, A0, B0)
    assert iters < 0 and info == 0
    assert d.get("refine.fallbacks") == 1
    assert d.get(f"faults.injected.{site}") == 1
    assert faults.stats()[site] == {"calls": 1, "fired": 1}
    assert checks.solve_residual(A0, X, B0) < 100 * EPS64
    # fired once: the next call converges without the fallback
    _X, info, iters = _drive(stt, spd, False, A0, B0)
    assert iters >= 0 and info == 0


def test_fault_triggers_and_arming():
    with pytest.raises(ValueError):
        faults.arm("no_such_site", once=True)
    faults.arm("host_death", once=True)  # the fleet sites are the JAX package's too
    faults.disarm("host_death")
    with pytest.raises(ValueError):
        faults.arm("info_nonzero", p=0.5, every=2)
    t = torch.arange(4.0)
    assert faults.corrupt("result_corrupt", t) is t  # off: untouched
    faults.arm("result_corrupt", every=2)
    faults.on()
    got = [faults.corrupt("result_corrupt", t) for _ in range(4)]
    assert [bool(torch.isnan(g[0])) for g in got] == [False, True, False, True]
    assert not torch.isnan(t).any()  # a fresh copy is poisoned
    zero = torch.zeros(1, dtype=torch.int32)
    faults.arm("info_nonzero", p=0.5, seed=3, info=7)
    a = [int(faults.poison_info("info_nonzero", zero)[0]) for _ in range(16)]
    faults.arm("info_nonzero", p=0.5, seed=3, info=7)
    b = [int(faults.poison_info("info_nonzero", zero)[0]) for _ in range(16)]
    assert a == b and set(a) == {0, 7}  # a pure function of the seed
    assert int(zero[0]) == 0
    faults.disarm("info_nonzero")
    assert faults.poison_info("info_nonzero", zero) is zero


def test_refine_span_event_and_annotation():
    n = 48
    A0, B0 = cond_matrix(n, 1e3, device="cpu"), _rhs(n)
    _drive(stt, False, False, A0, B0)
    assert spans.snapshot() == []  # off: nothing recorded
    spans.on()
    _X, _info, iters = _drive(stt, False, False, A0, B0)
    ev = [s for s in spans.snapshot() if s.name == "refine"]
    assert len(ev) == 1 and ev[0].kind == "instant"
    assert ev[0].attrs == {"routine": "gesv_mixed", "refine_iters": iters,
                           "refine_converged": True}
    with spans.span("solve") as sp:
        _drive(stt, True, True, cond_matrix(n, 1e3, spd=True, device="cpu"), B0)
    assert sp.attrs["refine_iters"] == 1 and sp.attrs["refine_converged"] is True
    assert spans.snapshot()[-1] is sp and sp.t_end >= sp.t_start
    faults.arm("info_nonzero", once=True)
    faults.on()
    _drive(stt, False, False, A0, B0)
    assert spans.snapshot()[-1].name == "refine_fallback"


# ---------------------------------------------------------------------------
# the serve tier's core
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("routine", ["gesv", "posv"])
def test_serve_mixed_core_matches_jax(routine):
    n = 40
    spd = routine == "posv"
    A0 = jcond(n, 1e3, spd=spd)
    if spd:
        A0 = np.tril(A0) + np.triu(np.full((n, n), 1e300), 1)  # only the lower triangle is read
    B0 = _rhs(n, 3)
    Xj, info_j = jmixed.serve_mixed_core(routine, jnp.asarray(A0), jnp.asarray(B0), 16)
    Xt, info_t = tmixed.serve_mixed_core(routine, torch.from_numpy(A0), torch.from_numpy(B0), 16)
    assert int(info_t) == int(info_j) == 0
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0, atol=_tol(n, np.asarray(Xj)))


@pytest.mark.parametrize("routine", ["gesv", "posv"])
def test_serve_mixed_core_poisons_a_stalled_solve(routine):
    n = 40
    A0 = cond_matrix(n, 1e9, spd=routine == "posv", device="cpu")
    Xt, info = tmixed.serve_mixed_core(routine, torch.from_numpy(A0),
                                       torch.from_numpy(_rhs(n)), 16)
    assert torch.isnan(Xt).all() and int(info) == 0
    Xj, _ = jmixed.serve_mixed_core(routine, jnp.asarray(A0), jnp.asarray(_rhs(n)), 16)
    assert np.isnan(np.asarray(Xj)).all()
    with pytest.raises(ValueError):
        tmixed.serve_mixed_core("gels", torch.from_numpy(A0), torch.from_numpy(_rhs(n)), 16)
