"""Port parity: the plain versions of the Hopper kernels in
``slate_tpu_torch/ops/hopper/panel_kernels.py`` against the JAX
package's Pallas kernels (interpret mode) and their jnp references.

On the CPU every wrapper takes its plain version, so these tests also
show that the wrappers leave the launch counters at 0 there.  The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.

The tolerance is ``50 n eps max|ref|``, as in tests/test_pallas_panels.py.
float64 rides tier-1; float32 is marked slow, as the JAX tests do."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.ops.pallas import panel_kernels as jpk
from slate_tpu_torch.ops.hopper import panel_kernels as pk

torch.set_num_threads(1)

DTYPES = [pytest.param(np.float32, marks=pytest.mark.slow), np.float64]


def _tol(dtype, n, ref):
    return 50 * n * np.finfo(dtype).eps * max(float(np.abs(ref).max()), 1.0)


def _rand(rng, m, n, dtype):
    return rng.standard_normal((m, n)).astype(dtype)


def _spd(rng, n, dtype):
    a = rng.standard_normal((n, n))
    return (a @ a.T + n * np.eye(n)).astype(dtype)


def _tri(rng, n, dtype, lower, unit):
    """Well-conditioned triangle, as the JAX tests build it."""
    a = rng.standard_normal((n, n)) * 0.3
    t = np.tril(a, -1) if lower else np.triu(a, 1)
    d = np.ones(n) if unit else 2.0 + np.abs(rng.standard_normal(n))
    return (t + np.diag(d)).astype(dtype)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(autouse=True)
def _zero_counters():
    pk.reset_launches()
    yield
    # the CPU path never launches a kernel
    assert all(v == 0 for v in pk.LAUNCHES.values()), pk.LAUNCHES


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [48, 64])
def test_chol_base_plain_matches_pallas(dtype, b):
    rng = np.random.default_rng(b)
    g = _spd(rng, b, dtype)
    g_junk = g + np.triu(_rand(rng, b, b, dtype), 1)  # above the diagonal
    ref_i = np.tril(np.asarray(jpk.chol_base_pallas(jnp.asarray(g), interpret=True)))
    ref_r = np.asarray(jpk.chol_base_reference(jnp.asarray(g)))
    got = pk.chol_base(_t(g_junk)).numpy()
    np.testing.assert_array_equal(np.triu(got, 1), np.triu(g_junk, 1))
    for ref in (ref_i, ref_r):
        np.testing.assert_allclose(np.tril(got), np.tril(ref), rtol=0,
                                   atol=_tol(dtype, b, ref))
    np.testing.assert_array_equal(pk.chol_base_plain(_t(g_junk)).numpy(), got)


def test_chol_base_non_spd_gives_nan():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((32, 32))
    got = pk.chol_base(_t(a + a.T)).numpy()
    assert not np.isfinite(np.tril(got)).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,h", [(48, 40), (64, 130)])
def test_syrk_diag_plain_matches_pallas(dtype, t, h):
    rng = np.random.default_rng(t + h)
    c, a = _rand(rng, t, t, dtype), _rand(rng, t, h, dtype)
    ref_i = np.asarray(jpk.syrk_diag_pallas(jnp.asarray(c), jnp.asarray(a), interpret=True))
    ref_r = np.asarray(jpk.syrk_diag_reference(jnp.asarray(c), jnp.asarray(a)))
    got = pk.syrk_diag(_t(c), _t(a)).numpy()
    np.testing.assert_array_equal(np.triu(got, 1), np.triu(c, 1))
    for ref in (ref_i, ref_r):
        np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype, h, ref))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k", [(40, 24, 56), (64, 64, 128)])
def test_gemm_sub_plain_matches_pallas(dtype, m, n, k):
    rng = np.random.default_rng(m * n + k)
    c, a, b = _rand(rng, m, n, dtype), _rand(rng, m, k, dtype), _rand(rng, n, k, dtype)
    ja = [jnp.asarray(x) for x in (c, a, b)]
    ref_i = np.asarray(jpk.gemm_sub_pallas(*ja, interpret=True))
    ref_r = np.asarray(jpk.gemm_sub_reference(*ja))
    got = pk.gemm_sub(_t(c), _t(a), _t(b)).numpy()
    for ref in (ref_i, ref_r):
        np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype, k, ref))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("unit", [False, True])
def test_trsm_lower_plain_matches_pallas(dtype, unit):
    rng = np.random.default_rng(7 + unit)
    n, nrhs = 96, 5
    lo, b = _tri(rng, n, dtype, True, unit), _rand(rng, n, nrhs, dtype)
    ref_i = np.asarray(jpk.trsm_lower_pallas(jnp.asarray(lo), jnp.asarray(b), unit=unit,
                                             interpret=True))
    ref_r = np.asarray(jpk.trsm_lower_reference(jnp.asarray(lo), jnp.asarray(b), unit=unit))
    got = pk.trsm_lower(_t(lo), _t(b), unit=unit).numpy()
    for ref in (ref_i, ref_r):
        np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype, n, ref))


@pytest.mark.parametrize("dtype", DTYPES)
def test_trsm_upper_plain_matches_pallas(dtype):
    rng = np.random.default_rng(11)
    n, nrhs = 96, 5
    lo, b = _tri(rng, n, dtype, True, False), _rand(rng, n, nrhs, dtype)
    up = np.ascontiguousarray(lo.T)
    ref_i = np.asarray(jpk.trsm_upper_pallas(jnp.asarray(up), jnp.asarray(b), interpret=True))
    ref_r = np.asarray(jpk.trsm_upper_reference(jnp.asarray(up), jnp.asarray(b)))
    got = pk.trsm_upper(_t(up), _t(b)).numpy()
    # the transposed read: L given, L^T X = B solved
    got_t = pk.trsm_upper(_t(lo), _t(b), transposed=True).numpy()
    for ref in (ref_i, ref_r):
        np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype, n, ref))
        np.testing.assert_allclose(got_t, ref, rtol=0, atol=_tol(dtype, n, ref))


@pytest.mark.parametrize("lower", [True, False])
def test_trsm_reads_one_triangle_of_packed_storage(lower):
    """Packed LU storage: the other triangle holds the other factor (here
    NaN) and must not enter the solve; ``unit`` skips the diagonal too."""
    rng = np.random.default_rng(13)
    n, nrhs = 64, 3
    t = _tri(rng, n, np.float64, lower, unit=lower)
    b = _rand(rng, n, nrhs, np.float64)
    ones = np.ones((n, n), bool)
    other = np.triu(ones) if lower else np.tril(ones, -1)  # lower: unit, so the diagonal too
    packed = np.where(other, np.nan, t)
    if lower:
        clean = pk.trsm_lower(_t(t), _t(b), unit=True).numpy()
        got = pk.trsm_lower(_t(packed), _t(b), unit=True).numpy()
        ref = np.asarray(jpk.trsm_lower_reference(jnp.asarray(t), jnp.asarray(b), unit=True))
    else:
        clean = pk.trsm_upper(_t(t), _t(b)).numpy()
        got = pk.trsm_upper(_t(packed), _t(b)).numpy()
        ref = np.asarray(jpk.trsm_upper_reference(jnp.asarray(t), jnp.asarray(b)))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, clean)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(np.float64, n, ref))


def test_wrappers_reject_bad_shapes():
    a = torch.zeros(4, 3, dtype=torch.float64)
    with pytest.raises(ValueError):
        pk.chol_base(a)
    with pytest.raises(ValueError):
        pk.gemm_sub(torch.zeros(4, 4, dtype=torch.float64), a, a[:3, :2])
    with pytest.raises(ValueError):
        pk.trsm_lower(torch.zeros(4, 4, dtype=torch.float64), torch.zeros(5, 2))

