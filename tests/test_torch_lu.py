"""Port parity: the LU schedules and drivers of slate_tpu_torch against
the JAX package, on the CPU.

The same numpy inputs (seeded) go through both packages.  The pallas
schedule runs the JAX package's Pallas panel in interpret mode and this
package's plain panel version; the FLOP, route and launch mirrors are
pure Python and must agree exactly.  Pivot orders must be bitwise equal
(random inputs have no exact ties).  Tolerance: ``50 n eps max|ref|``
for factors and solutions, as in tests/test_torch_chol.py."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu.drivers import lu as jlu
from slate_tpu.ops import lu_fast as jlf
from slate_tpu.ops import lu_kernels as jlk
from slate_tpu.testing import checks
from slate_tpu_torch.drivers import lu as tlu
from slate_tpu_torch.ops import chol_kernels as tck
from slate_tpu_torch.ops import lu_fast as tlf
from slate_tpu_torch.ops import lu_kernels as tlk
from slate_tpu_torch.ops.hopper import panel_kernels as pk

torch.set_num_threads(1)

CPU = stt.ProcessGrid.single("cpu")


def _tol(n, ref, dtype=np.float64):
    return 50 * n * np.finfo(dtype).eps * max(float(np.abs(ref).max()), 1.0)


def _rand(m, n, seed):
    return np.random.default_rng(seed).standard_normal((m, n))


@pytest.fixture(autouse=True)
def _no_launches():
    pk.reset_launches()
    yield
    assert all(v == 0 for v in pk.LAUNCHES.values()), pk.LAUNCHES  # CPU: plain versions


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["recursive", "pallas"])
@pytest.mark.parametrize("m,n,lookahead", [(384, 384, 1), (384, 384, 2), (320, 192, 1)])
def test_getrf_recursive_matches_jax(family, m, n, lookahead):
    a = _rand(m, n, m + n + lookahead)
    ref_lu, ref_p = jlk.getrf_recursive(jnp.asarray(a), 64, lookahead, family)
    got_lu, got_p = tlk.getrf_recursive(torch.from_numpy(a), 64, lookahead, family)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    ref_lu = np.asarray(ref_lu)
    np.testing.assert_allclose(got_lu.numpy(), ref_lu, rtol=0, atol=_tol(m, ref_lu))


@pytest.mark.parametrize("family", ["recursive", "pallas"])
def test_getrf_recursive_complex_matches_jax(family):
    """complex128 on the CPU: |z| pivoting, same pivot order."""
    rng = np.random.default_rng(17)
    a = rng.standard_normal((192, 192)) + 1j * rng.standard_normal((192, 192))
    ref_lu, ref_p = jlk.getrf_recursive(jnp.asarray(a), 64, 1, family)
    got_lu, got_p = tlk.getrf_recursive(torch.from_numpy(a), 64, 1, family)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    ref_lu = np.asarray(ref_lu)
    np.testing.assert_allclose(got_lu.numpy(), ref_lu, rtol=0, atol=_tol(192, ref_lu))


def test_getrf_recursive_without_pivoting_factors():
    n = 256
    a = _rand(n, n, 5) + n * np.eye(n)
    lu, p = tlk.getrf_recursive(torch.from_numpy(a), 64, 1, "pallas", pivot=False)
    lu = lu.numpy()
    np.testing.assert_array_equal(p.numpy(), np.arange(n))
    L, U = np.tril(lu, -1) + np.eye(n), np.triu(lu)
    np.testing.assert_allclose(L @ U, a, rtol=0, atol=_tol(n, a))


def test_flat_schedules_match_jax():
    a = _rand(256, 256, 7)
    ref_lu, ref_p = jlk.blocked_getrf(jnp.asarray(a), 64)
    got_lu, got_p = tlk.blocked_getrf(torch.from_numpy(a), 64)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    np.testing.assert_allclose(got_lu.numpy(), np.asarray(ref_lu), rtol=0,
                               atol=_tol(256, np.asarray(ref_lu)))
    ref_lu, ref_p = jlf.blocked_getrf_fast(jnp.asarray(a), 64)
    got_lu, got_p = tlf.blocked_getrf_fast(torch.from_numpy(a), 64)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    np.testing.assert_allclose(got_lu.numpy(), np.asarray(ref_lu), rtol=0,
                               atol=_tol(256, np.asarray(ref_lu)))


FLOP_GRID = list(itertools.product(
    [(256, 256), (1024, 1024), (2048, 2048), (4096, 4096), (3000, 2048), (16384, 16384)],
    [128, 512],                                          # nb
    ["flat", "flat_fast", "recursive", "pallas", "vendor"],
    [64, 256],                                           # nb_switch
    [1, 3],                                              # lookahead
))


def test_getrf_schedule_flops_equal_jax():
    for (m, n), nb, sched, nbs, la in FLOP_GRID:
        for true in ((None, None), (m - 24, n - 24)):
            j = jlk.getrf_schedule_flops(m, n, nb, sched, nbs, la, *true)
            t = tlk.getrf_schedule_flops(m, n, nb, sched, nbs, la, *true)
            assert t == j, ((m, n), nb, sched, nbs, la, true)


@pytest.mark.parametrize("M", [1, 2, 3, 5, 100, 128, 129, 192, 193, 16383, 16385])
def test_lat_height_and_split_point_match_jax(M):
    from slate_tpu.ops import chol_kernels as jck

    assert tck._lat_height(M) == jck._lat_height(M)
    assert tck.split_point(M) == jck.split_point(M)


@pytest.mark.parametrize("sched", ["auto", "flat", "recursive", "pallas", "vendor"])
@pytest.mark.parametrize("m,n", [(100, 100), (2048, 2048), (4096, 4096), (2304, 2048),
                                 (1000, 2000)])
def test_resolve_lu_schedule_matches_jax_on_cpu(sched, m, n):
    got = tlk.resolve_lu_schedule(m, n, torch.float64, sched, "cpu")
    assert got == jlk.resolve_lu_schedule(m, n, jnp.float64, sched)
    if sched == "auto":
        assert got == "vendor"


def test_resolve_lu_schedule_on_cuda_takes_the_kernels():
    assert tlk.resolve_lu_schedule(16384, 16384, torch.float64, "auto", "cuda") == "pallas"
    assert tlk.resolve_lu_schedule(2048, 2048, torch.float32, "auto", "cuda") == "pallas"
    assert tlk.resolve_lu_schedule(1024, 1024, torch.float64, "auto", "cuda") == "vendor"
    assert tlk.resolve_lu_schedule(4096, 2048, torch.float64, "auto", "cuda") == "vendor"


def test_kernel_launch_mirror(monkeypatch):
    assert tlk.getrf_kernel_launches(16384, 256, 1) == 64
    assert tlk.getrf_kernel_launches(16384, 256, 3) == 2 + tlk.getrf_kernel_launches(
        16384 - 512, 256, 1)
    assert tlk.getrf_kernel_launches(200, 256) == 1
    calls = []
    real = pk.panel_lu

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pk, "panel_lu", counting)
    for n, la in ((448, 1), (448, 3), (320, 2)):
        calls.clear()
        tlk.getrf_recursive(torch.from_numpy(_rand(n, n, n)), 64, la, "pallas")
        assert len(calls) == tlk.getrf_kernel_launches(n, 64, la), (n, la)
        units = jlk.getrf_schedule_flops(n, n, 64, "pallas", 64, la)["units"]
        assert len(calls) >= sum(1 for u in units if u[0] == "pallas_lu_panel")


def test_vendor_pivots_are_a_forward_permutation():
    """LAPACK's ipiv from torch.linalg.lu_factor is a sequence of row
    interchanges, not a permutation; converted, P A = L U holds and the
    permutation is the one lax.linalg.lu returns."""
    n = 150
    a = _rand(n, n, 11)
    LU, ipiv = torch.linalg.lu_factor(torch.from_numpy(a))
    perm = tlk.ipiv_to_perm(ipiv, n).numpy()
    assert perm.dtype == np.int32 and sorted(perm) == list(range(n))
    lu = LU.numpy()
    L, U = np.tril(lu, -1) + np.eye(n), np.triu(lu)
    np.testing.assert_allclose(L @ U, a[perm], rtol=0, atol=_tol(n, a))
    _, _, ref_perm = lax.linalg.lu(jnp.asarray(a))
    np.testing.assert_array_equal(perm, np.asarray(ref_perm))
    lu2, p2 = tlk.lu_global(torch.from_numpy(a), 64, "auto")
    np.testing.assert_array_equal(p2.numpy(), perm)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def _both(a, nb, grid11):
    return (st.Matrix.from_global(jnp.asarray(a), nb, grid=grid11),
            stt.Matrix.from_global(a, nb, grid=CPU))


@pytest.mark.parametrize("sched", ["auto", "flat", "recursive", "pallas"])
def test_gesv_getrf_getrs_match_jax(sched, grid11):
    n, nb, nrhs = 200, 64, 3  # 200 is not a multiple of the tile
    a, b = _rand(n, n, 21), _rand(n, nrhs, 22)
    opts = {"schedule": sched, "block_size": 64}
    JA, TA = _both(a, nb, grid11)
    JB, TB = _both(b, nb, grid11)
    JX, JLU, jpiv, jinfo = st.gesv(JA, JB, opts)
    TX, TLU, tpiv, tinfo = stt.gesv(TA, TB, opts)
    assert int(tinfo) == int(jinfo) == 0
    assert tpiv.perm.dtype == torch.int32
    np.testing.assert_array_equal(tpiv.perm.numpy(), np.asarray(jpiv.perm))
    ref_lu = np.asarray(JLU.to_global())
    np.testing.assert_allclose(TLU.to_global().numpy(), ref_lu, rtol=0, atol=_tol(n, ref_lu))
    ref_x = np.asarray(JX.to_global())
    x = TX.to_global().numpy()
    np.testing.assert_allclose(x, ref_x, rtol=0, atol=_tol(n, ref_x))
    assert checks.passed(checks.solve_residual(a, x, b), np.float64)
    # getrs alone, and getri, on the port's own factor
    X2 = stt.getrs(TLU, tpiv, TB, opts).to_global().numpy()
    np.testing.assert_array_equal(X2, x)
    inv = stt.getri(TLU, tpiv, opts).to_global().numpy()
    ref_inv = np.asarray(st.getri(JLU, jpiv, opts).to_global())
    np.testing.assert_allclose(inv, ref_inv, rtol=0, atol=_tol(n, ref_inv))


def test_gesv_nopiv_matches_jax(grid11):
    n, nb = 192, 64
    a, b = _rand(n, n, 31) + n * np.eye(n), _rand(n, 2, 32)
    JA, TA = _both(a, nb, grid11)
    JB, TB = _both(b, nb, grid11)
    for opts in ({}, {"schedule": "pallas", "block_size": 64}):
        JX, JLU, _, jinfo = jlu.gesv_nopiv(JA, JB, opts)
        TX, TLU, tpiv, tinfo = stt.gesv_nopiv(TA, TB, opts)
        assert int(tinfo) == int(jinfo) == 0 and tpiv.perm.numel() == 0
        for got, ref in ((TLU, JLU), (TX, JX)):
            ref = np.asarray(ref.to_global())
            np.testing.assert_allclose(got.to_global().numpy(), ref, rtol=0, atol=_tol(n, ref))


@pytest.mark.parametrize("sched", ["auto", "pallas", "recursive"])
def test_singular_matrix_sets_info(sched, grid11):
    n, nb = 128, 32
    a = _rand(n, n, 41)
    a[:, 17] = 0.0  # one exact zero column
    b = np.ones((n, 1))
    opts = {"schedule": sched, "block_size": 64}
    JA, TA = _both(a, nb, grid11)
    _, jpiv, jinfo = st.getrf(JA, opts)
    TLU, tpiv, tinfo = stt.getrf(TA, opts)
    assert int(tinfo) > 0 and int(jinfo) > 0
    np.testing.assert_array_equal(tpiv.perm.numpy(), np.asarray(jpiv.perm))
    _, _, _, info = stt.gesv(TA, stt.Matrix.from_global(b, nb, grid=CPU), opts)
    assert int(info) > 0


@pytest.mark.parametrize("sched", ["pallas", "auto"])
def test_getrs_from_global_matches_jax(sched):
    n, nrhs = 160, 5
    a, b = _rand(n, n, 51), _rand(n, nrhs, 52)
    lu, _, perm = lax.linalg.lu(jnp.asarray(a))
    lu, perm = np.array(lu), np.array(perm)
    pb = b[perm]
    ref = np.asarray(jlu.getrs_from_global(jnp.asarray(lu), jnp.asarray(pb), sched))
    got = stt.getrs_from_global(torch.from_numpy(lu), torch.from_numpy(pb), sched).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(n, ref))
    assert checks.passed(checks.solve_residual(a, got, b), np.float64)


def test_getrs_from_global_pallas_reads_one_triangle():
    """Packed LU: the plain route of the pallas schedule reads only the
    strict lower triangle for L (unit diagonal) and only the upper
    triangle for U; junk planted outside each changes nothing."""
    n, nrhs = 96, 4
    rng = np.random.default_rng(61)
    L = np.tril(rng.standard_normal((n, n)) * 0.3, -1) + np.eye(n)
    U = np.triu(rng.standard_normal((n, n)) * 0.3, 1) + np.diag(2 + rng.random(n))
    b = rng.standard_normal((n, nrhs))
    packed = np.tril(L, -1) + U
    got = stt.getrs_from_global(torch.from_numpy(packed), torch.from_numpy(b), "pallas").numpy()
    np.testing.assert_allclose(L @ U @ got, b, rtol=0, atol=_tol(n, b) * n)
    # the lower solve on its own: junk on and above the diagonal
    junk_up = np.tril(L, -1) + np.triu(rng.standard_normal((n, n)))
    y = pk.trsm_lower(torch.from_numpy(junk_up), torch.from_numpy(b), unit=True).numpy()
    np.testing.assert_array_equal(
        y, pk.trsm_lower(torch.from_numpy(L), torch.from_numpy(b), unit=True).numpy())
    # the upper solve on its own: junk below the diagonal
    junk_lo = U + np.tril(rng.standard_normal((n, n)), -1)
    x = pk.trsm_upper(torch.from_numpy(junk_lo), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(x, pk.trsm_upper(torch.from_numpy(U), torch.from_numpy(y))
                                  .numpy())
    np.testing.assert_allclose(x, got, rtol=0, atol=_tol(n, got))


def test_gesv_rbt_matches_jax(grid11):
    """The random butterfly solve at n = 32 (the JAX package's bound:
    residual <= 1000 eps), and the transform itself against gerbt."""
    n, nb, nrhs = 32, 8, 3
    a, b = _rand(n, n, 71), _rand(n, nrhs, 72)
    JA, TA = _both(a, nb, grid11)
    JB, TB = _both(b, nb, grid11)
    opts = {"method_lu": "rbt"}
    JX, JLU, _, jinfo = st.gesv(JA, JB, opts)
    TX, TLU, tpiv, tinfo = stt.gesv(TA, TB, opts)
    assert int(tinfo) == int(jinfo) == 0 and tpiv.perm.numel() == 0
    x = TX.to_global().numpy()
    assert checks.passed(checks.solve_residual(a, x, b), np.float64, factor=1000)
    ref_x = np.asarray(JX.to_global())
    np.testing.assert_allclose(x, ref_x, rtol=0, atol=_tol(n, ref_x))
    # the no-pivot factor grows, so the elements differ by more than
    # rounding; the factorization of the JAX package's transformed
    # matrix is what must hold
    Gp = np.asarray(jlu._gerbt_full(JA, 2, 42)[0])
    lu = TLU.to_global().numpy()
    L, U = np.tril(lu, -1) + np.eye(n), np.triu(lu)
    np.testing.assert_allclose(L @ U, Gp, rtol=0, atol=_tol(n, np.abs(L) @ np.abs(U)))
    jr, jdu, jdv = jlu.gerbt(JA)
    tr, tdu, tdv = stt.gerbt(TA)
    ref = np.asarray(jr.to_global())
    np.testing.assert_allclose(tr.to_global().numpy(), ref, rtol=0, atol=_tol(n, ref))
    np.testing.assert_array_max_ulp(tdu.numpy(), np.asarray(jdu), maxulp=2)


def test_getrs_solves_a_jax_factorization(grid11):
    """convert.getrf_from_reference: the port's getrs and
    getrs_from_global solve with the JAX package's own factors."""
    n, nb, nrhs = 150, 32, 4  # padded rows: the permutation covers 160
    a, b = _rand(n, n, 81), _rand(n, nrhs, 82)
    JA, _ = _both(a, nb, grid11)
    JLU, jpiv, _ = st.getrf(JA, {"schedule": "recursive", "block_size": 64})
    lay = JLU.layout
    LU, piv = stt.getrf_from_reference(
        np.asarray(JLU.data), np.asarray(jpiv.perm), m=lay.m, n=lay.n, mb=lay.mb,
        nb=lay.nb, p=lay.p, q=lay.q, device="cpu")
    assert piv.perm.dtype == torch.int32 and piv.perm.shape[0] == 160
    X = stt.getrs(LU, piv, stt.Matrix.from_global(b, nb, grid=CPU)).to_global().numpy()
    assert checks.passed(checks.solve_residual(a, X, b), np.float64)
    pb = piv.apply(torch.from_numpy(b))
    Y = stt.getrs_from_global(LU.to_global(), pb, "pallas").numpy()
    np.testing.assert_allclose(Y, X, rtol=0, atol=_tol(n, X))
    np.testing.assert_array_equal(piv.apply_inverse(pb).numpy(), b)


def test_getrf_records_factor_flops():
    from slate_tpu_torch.aux import metrics

    n = 256
    A = stt.Matrix.from_global(_rand(n, n, 91), 64, grid=CPU)
    metrics.reset()
    metrics.on()
    try:
        stt.getrf(A, {"schedule": "pallas", "block_size": 64})
        got = metrics.counters()
    finally:
        metrics.off()
        metrics.reset()
    fl = tlk.getrf_schedule_flops(n, n, 64, "pallas", 64, 1)
    assert got["factor.getrf.flops_exec"] == fl["exec"]
    assert got["factor.getrf.flops_model"] == fl["model"]
    assert got["getrf.calls"] == 1
