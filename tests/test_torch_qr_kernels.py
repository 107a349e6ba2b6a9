"""Port parity: the plain version of the QR path's Hopper kernel
(``larft`` in ``slate_tpu_torch/ops/hopper/panel_kernels.py``) against
the JAX package's Pallas kernel in interpret mode and its jnp reference.

On the CPU every wrapper takes its plain version, so these tests also
show that the wrappers leave the launch counters at 0 there.  The CUDA
kernel is held against the plain version on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.

Inputs: the consistent (V, tau) of tests/test_pallas_panels.py
(unit-diagonal V with a small strict lower part, tau = 2 / ||v||^2, so
T^-1 is well conditioned), plus absent reflectors (tau = 0) and short
taus vectors.  Tolerance: ``50 m eps max(|T|, 1)``, as there; the T^-1
diagonal (one IEEE division each) and the tau = 0 rows and columns are
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.ops import householder as jh
from slate_tpu.ops.pallas import panel_kernels as jpk
from slate_tpu_torch.ops import householder as th
from slate_tpu_torch.ops.hopper import panel_kernels as pk

torch.set_num_threads(1)

DTYPES = [np.float32, np.float64]


def _tol(dtype, m, ref):
    return 50 * m * np.finfo(dtype).eps * max(float(np.abs(ref).max()), 1.0)


@pytest.fixture(autouse=True)
def _zero_counters():
    pk.reset_launches()
    yield
    assert all(v == 0 for v in pk.LAUNCHES.values()), pk.LAUNCHES  # CPU: plain versions


def _consistent(m, nb, dtype, seed, dead=(), complex_=False):
    rng = np.random.default_rng(seed)
    low = rng.standard_normal((m, nb))
    if complex_:
        low = low + 1j * rng.standard_normal((m, nb))
    V = np.tril(low, -1) * 0.1 + np.eye(m, nb)
    taus = 2.0 / (np.abs(V) ** 2).sum(0)
    taus[list(dead)] = 0.0
    return V.astype(dtype), taus.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,nb,dead,short", [
    (96, 32, (), 0),        # the shape of tests/test_pallas_panels.py
    (96, 32, (0, 17), 0),   # absent reflectors
    (40, 24, (5,), 3),      # a short taus vector: the last 3 are absent
    (7, 1, (), 0),
])
def test_larft_plain_matches_jax_kernel(dtype, m, nb, dead, short):
    V, taus = _consistent(m, nb, dtype, seed=m + nb, dead=dead)
    t = taus[: nb - short]
    ref_p = np.asarray(jpk.larft_pallas(jnp.asarray(V), jnp.asarray(t), interpret=True))
    ref_r = np.asarray(jpk.larft_reference(jnp.asarray(V), jnp.asarray(t)))
    Vt, tt = torch.from_numpy(V), torch.from_numpy(t)
    got = pk.larft_plain(Vt, tt).numpy()
    for ref in (ref_p, ref_r):
        np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype, m, ref))
    absent = np.flatnonzero(np.r_[t, np.zeros(short, dtype)] == 0)
    assert not got[absent].any() and not got[:, absent].any()
    # the wrapper takes the plain version on the CPU, and householder.larft
    # is the same plain assembly
    np.testing.assert_array_equal(pk.larft(Vt, tt).numpy(), got)
    np.testing.assert_array_equal(th.larft(Vt, tt).numpy(), got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_larft_tinv_plain_is_the_jax_kernel_body(dtype):
    """T^-1 = strict_upper(V^T V) + diag(d): the diagonal is 1/tau by one
    division (1e30 for tau = 0) and the lower triangle is exactly zero."""
    V, taus = _consistent(64, 16, dtype, seed=3, dead=(4,))
    ref = np.asarray(jpk._larft_tinv_body(jnp.asarray(V), jnp.asarray(taus)))
    got = pk.larft_tinv(torch.from_numpy(V), torch.from_numpy(taus)).numpy()
    np.testing.assert_array_equal(np.tril(got, -1), 0)
    np.testing.assert_array_equal(np.diag(got), np.diag(ref))
    assert np.diag(got)[4] == dtype(1e30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype, 64, ref))


def test_larft_complex_matches_jax():
    V, taus = _consistent(50, 12, np.complex128, seed=9, dead=(2,), complex_=True)
    ref = np.asarray(jh.larft(jnp.asarray(V), jnp.asarray(taus)))
    got = pk.larft_plain(torch.from_numpy(V), torch.from_numpy(taus)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(np.float64, 50, ref))


def test_larft_recovers_the_reflectors_product():
    """I - V T V^T equals the product of the reflectors H_j = I - tau_j
    v_j v_j^T (the LAPACK larft contract)."""
    m, nb = 30, 8
    V, taus = _consistent(m, nb, np.float64, seed=11, dead=(3,))
    T = pk.larft_plain(torch.from_numpy(V), torch.from_numpy(taus)).numpy()
    Q = np.eye(m)
    for j in range(nb):
        Q = Q @ (np.eye(m) - taus[j] * np.outer(V[:, j], V[:, j]))
    np.testing.assert_allclose(np.eye(m) - V @ T @ V.T, Q, rtol=0, atol=1e-13)


def test_larft_rejects_bad_shapes():
    with pytest.raises(ValueError):
        pk.larft_tinv(torch.zeros(5, 3, dtype=torch.float64), torch.zeros(4, dtype=torch.float64))
