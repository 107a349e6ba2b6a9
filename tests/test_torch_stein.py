"""Port parity: batched inverse iteration (``ops/stein.py``) and
``steqr(method="stein")`` of slate_tpu_torch against the JAX package on
the CPU, at the JAX tests' matrices (tests/test_stein.py).

The start vectors (Philox 2x64, seed 0x5E17) are bitwise equal to the
JAX package's; the vectors hold to the JAX tests' bound (residual and
orthogonality within ``5e-11 n`` of max|lambda|) and equal the JAX
package's up to sign where the spectrum is separated (more than 1e-3
max|lambda| from each neighbour)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.drivers.eig import steqr as jsteqr
from slate_tpu.matgen.philox import _bits_to_unit_jnp, philox_2x64_jnp
from slate_tpu.ops.bulge import tridiag_eigvals_bisect as jbisect
from slate_tpu.ops.stein import stein as jstein
from slate_tpu_torch.drivers.eig import steqr as tsteqr
from slate_tpu_torch.ops import stein as ts

torch.set_num_threads(1)


def _tridiag(d, e):
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


def _check_parity(Z, Zj, w):
    scale = max(np.abs(w).max(), 1e-30)
    gaps = np.diff(w)
    gap = np.minimum(np.concatenate([[np.inf], gaps]), np.concatenate([gaps, [np.inf]]))
    sep = gap > 1e-3 * scale
    sign = np.where((Z * Zj).sum(0) < 0, -1.0, 1.0)
    np.testing.assert_allclose((Z * sign)[:, sep], Zj[:, sep], rtol=0, atol=5e-11 * len(w))


@pytest.mark.parametrize("n", [2, 5, 37, 64])
def test_start_vectors_bitwise(n):
    ii = jnp.broadcast_to(jnp.arange(n)[:, None], (n, n)).reshape(-1)
    jj = jnp.broadcast_to(jnp.arange(n)[None, :], (n, n)).reshape(-1)
    Lbits, _ = philox_2x64_jnp(ii, jj, 0x5E17)
    ref = np.asarray(_bits_to_unit_jnp(Lbits, jnp.float64).reshape(n, n) - 0.5)
    np.testing.assert_array_equal(ts.start_vectors(n, torch.float64, "cpu").numpy(), ref)


def _cases():
    for n in (2, 3, 16, 64, 157):
        rng = np.random.default_rng(n)
        yield f"random{n}", rng.standard_normal(n), rng.standard_normal(max(n - 1, 0))
    yield "toeplitz", np.zeros(96), np.ones(95)
    yield "identity_cluster", np.ones(32), np.zeros(31)
    m = 10
    yield "wilkinson", np.abs(np.arange(-m, m + 1)).astype(float), np.ones(2 * m)
    rng = np.random.default_rng(5)
    yield "scaled", 1e8 * rng.standard_normal(48), 1e8 * rng.standard_normal(47)


CASES = {name: (d, e) for name, d, e in _cases()}


@pytest.mark.parametrize("name", list(CASES))
def test_stein_matches_jax(name):
    d, e = CASES[name]
    n = d.shape[0]
    wj = jbisect(jnp.asarray(d), jnp.asarray(e))
    Zj = np.asarray(jax.jit(jstein)(jnp.asarray(d), jnp.asarray(e), wj))
    wj = np.asarray(wj)
    Z = ts.stein(torch.from_numpy(d), torch.from_numpy(e), torch.from_numpy(wj.copy())).numpy()
    T = _tridiag(d, e)
    scale = max(np.abs(wj).max(), 1e-30)
    assert np.abs(T @ Z - Z * wj[None, :]).max() / scale < 5e-11 * n
    assert np.abs(Z.T @ Z - np.eye(n)).max() < 5e-11 * n
    _check_parity(Z, Zj, wj)


def test_steqr_method_stein_matches_jax():
    rng = np.random.default_rng(11)
    d, e = rng.standard_normal(40), rng.standard_normal(39)
    w, Z = tsteqr(torch.from_numpy(d), torch.from_numpy(e), vectors=True, method="stein")
    wj, Zj = jsteqr(jnp.asarray(d), jnp.asarray(e), vectors=True, method="stein")
    w, Z, wj, Zj = w.numpy(), Z.numpy(), np.asarray(wj), np.asarray(Zj)
    np.testing.assert_allclose(w, wj, rtol=0, atol=2 * 40 * np.finfo(float).eps * np.abs(wj).max())
    assert np.abs(_tridiag(d, e) @ Z - Z * w[None, :]).max() < 1e-10
    _check_parity(Z, Zj, wj)
