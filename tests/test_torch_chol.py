"""Port parity: the Cholesky schedules and drivers of slate_tpu_torch
against the JAX package, on the CPU.

The same numpy inputs (seeded) go through both packages.  The pallas
schedule runs the JAX package's Pallas kernels in interpret mode and
this package's plain kernel versions; the FLOP and launch mirrors are
pure Python and must agree exactly.  Tolerance: ``50 n eps max|ref|``
for factors and solutions, as in tests/test_pallas_panels.py."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu.drivers import chol as jchol
from slate_tpu.ops import chol_kernels as jck
from slate_tpu_torch.drivers import chol as tchol
from slate_tpu_torch.ops import chol_kernels as tck
from slate_tpu_torch.ops.hopper import panel_kernels as pk

torch.set_num_threads(1)

CPU = stt.ProcessGrid.single("cpu")


def _tol(n, ref, dtype=np.float64):
    return 50 * n * np.finfo(dtype).eps * max(float(np.abs(ref).max()), 1.0)


def _spd(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


FLOP_GRID = list(itertools.product(
    [100, 256, 384, 1000, 2048, 4096],       # n
    [128, 512],                               # nb
    ["flat", "flat_fori", "recursive", "pallas", "vendor"],
    [64, 256],                                # nb_switch
    [1, 3],                                   # lookahead
))


def test_chol_schedule_flops_equal_jax():
    for n, nb, sched, nbs, la in FLOP_GRID:
        j = jck.chol_schedule_flops(n, nb, sched, nbs, la)
        t = tck.chol_schedule_flops(n, nb, sched, nbs, la)
        assert t == j, (n, nb, sched, nbs, la)


@pytest.mark.parametrize("n", [100, 2048, 16384])
def test_split_point_and_launch_mirror(n):
    assert tck.split_point(n) == jck.split_point(n)
    units = jck.chol_schedule_flops(n, 512, "pallas", 256, 1)["units"]
    launches = tck.chol_kernel_launches(n, 256)
    # every distinct kernel shape of the schedule is launched at least once
    for op, name in (("pallas_chol_base", "chol_base"), ("pallas_syrk", "syrk_diag"),
                     ("pallas_gemm", "gemm_sub")):
        shapes = sum(1 for u in units if u[0] == op)
        assert launches[name] >= shapes, (name, launches, shapes)


def test_launch_mirror_matches_the_recursion_at_16384():
    assert tck.chol_kernel_launches(16384) == {
        "chol_base": 64, "syrk_diag": 192, "gemm_sub": 129}
    assert tck.chol_kernel_launches(8192) == {
        "chol_base": 32, "syrk_diag": 80, "gemm_sub": 49}


@pytest.mark.parametrize("sched", ["auto", "flat", "recursive", "pallas", "vendor"])
@pytest.mark.parametrize("n", [100, 2048, 4096])
def test_resolve_schedule_matches_jax_on_cpu(sched, n):
    assert tck.resolve_schedule(n, torch.float64, sched, "cpu") == jck.resolve_schedule(n, sched)


@pytest.mark.parametrize("sched", ["recursive", "pallas", "flat"])
@pytest.mark.parametrize("n", [192, 200, 384])
def test_cholesky_schedules_match_jax(sched, n):
    g = _spd(n, n)
    ref = np.asarray(jck.cholesky(jnp.asarray(g), 128, sched, 64))
    got = tck.cholesky(torch.from_numpy(g), 128, sched, 64)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_tol(n, ref))
    np.testing.assert_array_equal(np.triu(got.numpy(), 1), 0)


def test_cholesky_lookahead_matches_jax():
    n = 384
    g = _spd(n, 3)
    ref = np.asarray(jck.chol_recursive(jnp.asarray(g), 64, 3, "pallas"))
    got = tck.chol_recursive(torch.from_numpy(g), 64, 3, "pallas").numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(n, ref))


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
def test_posv_matches_jax(uplo, grid11):
    n, nb, nrhs = 256, 64, 3
    a = _spd(n, 21)
    b = np.random.default_rng(22).standard_normal((n, nrhs))
    opts = {"schedule": "pallas", "block_size": 64}
    JA = st.HermitianMatrix.from_global(jnp.asarray(a), nb, grid=grid11, uplo=st.Uplo[uplo])
    JX, JL, jinfo = st.posv(JA, st.Matrix.from_global(jnp.asarray(b), nb, grid=grid11), opts)
    TA = stt.HermitianMatrix.from_global(a, nb, grid=CPU, uplo=stt.Uplo[uplo])
    pk.reset_launches()
    TX, TL, tinfo = stt.posv(TA, stt.Matrix.from_global(b, nb, grid=CPU), opts)
    assert all(v == 0 for v in pk.LAUNCHES.values())  # CPU: plain versions only
    assert int(tinfo) == int(jinfo) == 0
    assert TL.uplo.name == JL.uplo.name == uplo
    ref_l = np.asarray(JL.to_global())
    np.testing.assert_allclose(TL.to_global().numpy(), ref_l, rtol=0, atol=_tol(n, ref_l))
    ref_x = np.asarray(JX.to_global())
    np.testing.assert_allclose(TX.to_global().numpy(), ref_x, rtol=0, atol=_tol(n, ref_x))
    np.testing.assert_allclose(a @ TX.to_global().numpy(), b, rtol=0, atol=_tol(n, b) * n)


@pytest.mark.parametrize("sched", ["pallas", "auto"])
def test_potrs_from_global_matches_jax(sched):
    n, nrhs = 200, 6
    a = _spd(n, 31)
    lo = np.linalg.cholesky(a)
    b = np.random.default_rng(32).standard_normal((n, nrhs))
    ref = np.asarray(jchol.potrs_from_global(jnp.asarray(lo), jnp.asarray(b), sched))
    got = stt.potrs_from_global(torch.from_numpy(lo), torch.from_numpy(b), sched).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(n, ref))
    # only the lower triangle of the factor is read
    junk = lo + np.triu(np.full((n, n), np.nan), 1)
    got_j = stt.potrs_from_global(torch.from_numpy(junk), torch.from_numpy(b), sched).numpy()
    np.testing.assert_array_equal(got_j, got)


def test_solve_trsm_route_on_cpu():
    f64 = torch.float64
    assert tchol._solve_trsm_route(4096, f64, "auto", "cpu") == "vendor"
    assert tchol._solve_trsm_route(4096, f64, "pallas", "cpu") == "pallas"
    assert tchol._solve_trsm_route(4096, f64, "auto", "cuda") == "pallas"
    assert tchol._solve_trsm_route(1024, f64, "auto", "cuda") == "vendor"


@pytest.mark.parametrize("sched", ["pallas", "auto"])
def test_posv_non_spd_sets_info(sched):
    n = 128
    a = np.random.default_rng(41).standard_normal((n, n))
    a = a + a.T  # symmetric indefinite
    A = stt.HermitianMatrix.from_global(a, 32, grid=CPU)
    B = stt.Matrix.from_global(np.ones((n, 1)), 32, grid=CPU)
    _, _, info = stt.posv(A, B, {"schedule": sched, "block_size": 64})
    assert int(info) > 0


def test_potrf_records_factor_flops():
    from slate_tpu_torch.aux import metrics

    n = 256
    A = stt.HermitianMatrix.from_global(_spd(n, 51), 64, grid=CPU)
    metrics.reset()
    metrics.on()
    try:
        stt.potrf(A, {"schedule": "pallas", "block_size": 64})
        got = metrics.counters()
    finally:
        metrics.off()
        metrics.reset()
    fl = tck.chol_schedule_flops(n, 64, "pallas", 64, 1)
    assert got["factor.potrf.flops_exec"] == fl["exec"]
    assert got["factor.potrf.flops_model"] == fl["model"]
    assert got["potrf.calls"] == 1
