"""Port parity: the plain versions of the LU path's Hopper kernels
(``panel_lu``, ``butterfly_level`` in
``slate_tpu_torch/ops/hopper/panel_kernels.py``) against the JAX
package's Pallas kernels in interpret mode and their jnp references, and
the port's Philox generator against the JAX package's.

On the CPU every wrapper takes its plain version, so these tests also
show that the wrappers leave the launch counters at 0 there.  The CUDA
kernels are held against the plain versions on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.

Tolerances: perm bitwise equal; LU within 1e-12 (float64) and 1e-5
(float32) of max|ref| (XLA contracts the rank-1 update into fused
multiply-adds, PyTorch does not, so the floats differ by rounding);
butterfly levels within 4 eps of max|ref| (one fused multiply-add)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.drivers import lu as jlu
from slate_tpu.matgen import philox as jphilox
from slate_tpu.ops.pallas import kernels as jk
from slate_tpu.ops.pallas import panel_kernels as jpk
from slate_tpu_torch.drivers import lu as tlu
from slate_tpu_torch.matgen import philox as tphilox
from slate_tpu_torch.ops.hopper import panel_kernels as pk

torch.set_num_threads(1)

LU_RTOL = {np.float64: 1e-12, np.float32: 1e-5}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(autouse=True)
def _zero_counters():
    pk.reset_launches()
    yield
    # the CPU path never launches a kernel
    assert all(v == 0 for v in pk.LAUNCHES.values()), pk.LAUNCHES


def _panel(kind, m, nb, dtype, seed):
    P = np.random.default_rng(seed).standard_normal((m, nb))
    if kind == "ties":  # column 0 all +-1: the first row must win
        P[:, 0] = np.where(P[:, 0] > 0, 1.0, -1.0)
    elif kind == "zero_col":  # a zero pivot column: zero L column, no NaN
        P[:, 3] = 0.0
    return P.astype(dtype)


def _check_panel(P, pivot, act, dtype):
    jP = jnp.asarray(P)
    refs = [jpk.panel_lu_pallas(jP, pivot=pivot, act=act, interpret=True),
            jpk.panel_lu_reference(jP, pivot=pivot, act=act)]
    got_lu, got_perm = pk.panel_lu(_t(P), pivot=pivot, act=act)
    got_lu, got_perm = got_lu.numpy(), got_perm.numpy()
    assert got_perm.dtype == np.int32
    for lu_r, perm_r in refs:
        lu_r = np.asarray(lu_r)
        np.testing.assert_array_equal(got_perm, np.asarray(perm_r))
        tol = LU_RTOL[dtype] * max(float(np.abs(lu_r).max()), 1.0)
        np.testing.assert_allclose(got_lu, lu_r, rtol=0, atol=tol)
    plain_lu, plain_perm = pk.panel_lu_plain(_t(P), pivot, act)
    np.testing.assert_array_equal(plain_lu.numpy(), got_lu)
    np.testing.assert_array_equal(plain_perm.numpy(), got_perm)
    return got_lu, got_perm


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind,m,nb,act,pivot", [
    ("rand", 96, 32, None, True),      # tall
    ("rand", 160, 24, 120, True),      # act < M: rows past act never pivot
    ("rand", 64, 64, None, False),     # no exchanges
    ("ties", 80, 16, None, True),      # tied magnitudes: first index wins
    ("zero_col", 72, 16, None, True),  # zero pivot column
    ("rand", 20, 40, None, True),      # wide: min(M, nb) columns eliminated
])
def test_panel_lu_plain_matches_pallas(dtype, kind, m, nb, act, pivot):
    P = _panel(kind, m, nb, dtype, seed=m + nb)
    if pivot is False:
        P = P + np.float32(m) * np.eye(m, nb, dtype=dtype)  # no tiny pivots
    lu, perm = _check_panel(P, pivot, act, dtype)
    if act is not None:
        np.testing.assert_array_equal(perm[act:], np.arange(act, m))
    if not pivot:
        np.testing.assert_array_equal(perm, np.arange(m))
    if kind == "ties":
        assert perm[0] == 0
    if kind == "zero_col":
        assert np.isfinite(lu).all()
        np.testing.assert_array_equal(lu[4:, 3], 0)


def test_panel_lu_rejects_act_below_the_columns():
    with pytest.raises(ValueError):
        pk.panel_lu(torch.zeros(10, 4, dtype=torch.float64), act=3)
    with pytest.raises(ValueError):
        pk.panel_lu(torch.zeros(10, dtype=torch.float64))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("n2,w,h", [(64, 5, 32), (64, 5, 8), (32, 1, 16)])
def test_butterfly_level_plain_matches_pallas(dtype, transpose, n2, w, h):
    rng = np.random.default_rng(n2 + w + h)
    X = rng.standard_normal((n2, w)).astype(dtype)
    D = np.exp(rng.uniform(-0.1, 0.1, n2)).astype(dtype)
    blocks = n2 // (2 * h)

    def level(x, d):
        return jk.butterfly_level_pallas(x, d[:h], d[h:], transpose, interpret=True)

    ref_i = np.asarray(jax.vmap(level)(jnp.asarray(X).reshape(blocks, 2 * h, w),
                                       jnp.asarray(D).reshape(blocks, 2 * h))).reshape(n2, w)
    ref_r = np.asarray(jax.vmap(
        lambda x, d: jk.butterfly_level_reference(x, d[:h], d[h:], transpose))(
        jnp.asarray(X).reshape(blocks, 2 * h, w),
        jnp.asarray(D).reshape(blocks, 2 * h))).reshape(n2, w)
    got = pk.butterfly_level(_t(X), _t(D), h, transpose).numpy()
    assert got.dtype == X.dtype
    for ref in (ref_i, ref_r):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=4 * np.finfo(dtype).eps * float(np.abs(ref).max()))
    np.testing.assert_array_equal(pk.butterfly_level_plain(_t(X), _t(D), h, transpose).numpy(),
                                  got)


def test_butterfly_level_rejects_bad_shapes():
    X = torch.zeros(12, 3, dtype=torch.float64)
    with pytest.raises(ValueError):
        pk.butterfly_level(X, torch.zeros(12, dtype=torch.float64), 4, True)  # 12 % 8
    with pytest.raises(ValueError):
        pk.butterfly_level(X, torch.zeros(10, dtype=torch.float64), 3, True)


@pytest.mark.parametrize("dist", ["uniform", "uniform_signed"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_philox_bit_identical(dist, dtype):
    i = np.arange(3000, dtype=np.int64).reshape(30, 100) * 7919 + 2**40
    j = (i * 31) % 977
    seed = 2**63 + 12345
    ref_np = jphilox.random_np(dist, seed, i, j, getattr(np, dtype))
    ref_jnp = np.asarray(jphilox.random_jnp(dist, seed, jnp.asarray(i), jnp.asarray(j),
                                            getattr(jnp, dtype)))
    got_np = tphilox.random_np(dist, seed, i, j, getattr(np, dtype))
    got_t = tphilox.random_torch(dist, seed, _t(i), _t(j), getattr(torch, dtype)).numpy()
    for got in (got_np, got_t):
        np.testing.assert_array_equal(got, ref_np)
        np.testing.assert_array_equal(got, ref_jnp)


@pytest.mark.parametrize("n,depth,seed", [(64, 2, 42), (32, 3, 43)])
def test_butterfly_diags_match_jax(n, depth, seed):
    for dt_j, dt_t in ((jnp.float64, torch.float64), (jnp.float32, torch.float32)):
        ref = np.asarray(jlu._butterfly_diags(n, depth, seed, dt_j))
        got = tlu._butterfly_diags(n, depth, seed, dt_t, "cpu").numpy()
        assert got.shape == (depth, n)
        # exp in two libraries: within 2 ulp
        np.testing.assert_array_max_ulp(got, ref, maxulp=2)
