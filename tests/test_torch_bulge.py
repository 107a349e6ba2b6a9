"""Port parity: the bulge chase of slate_tpu_torch (``ops/bulge.py``: the
superstep wavefront ``hb2st``, the back-transforms ``unmtr_hb2st`` and
``_unmtr_hb2st_sweep``, ``tridiag_eigvals_bisect``) and its native host
chaser (``native``) against the JAX package on the CPU.

The same seeded numpy band goes through both packages, at the JAX
tests' shapes (tests/test_bulge.py).  The native chaser is the same C
source built by each package: d, e, VS and TAUS are bitwise equal, and
so is the ranged chase with overlapped uploads.  The wavefront agrees
with the JAX wavefront within ``10 n eps ||W||_1``; the back-transforms
within 1e-12 on the JAX package's reflectors; bisection within
``2 n eps max|lambda|``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu import native as jnative
from slate_tpu.ops import bulge as jb
from slate_tpu_torch import native as tnative
from slate_tpu_torch.ops import bulge as tb

torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps
SHAPES = [(24, 4), (50, 8), (37, 5), (30, 2)]


def _band(rng, n, b, dtype=np.float64):
    A = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        A = A + 1j * rng.standard_normal((n, n))
    A = (A + A.conj().T) / 2
    mask = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= b
    return (A * mask).astype(dtype)


def _storage(Ab, b):
    n = Ab.shape[0]
    n_pad = n + 4 * b + 8
    Wj = jb.band_to_storage(jnp.asarray(Ab), b, n_pad)
    Wt = tb.band_to_storage(torch.from_numpy(Ab), b, n_pad)
    np.testing.assert_array_equal(Wt.numpy(), np.asarray(Wj))
    return Wj, Wt


@pytest.mark.parametrize("n,b", SHAPES + [(64, 16)])
def test_native_chaser_bitwise(rng, n, b):
    assert tnative.hb2st_available() and jnative.hb2st_available()
    Wj, Wt = _storage(_band(rng, n, b), b)
    ref = jnative.hb2st_host(np.asarray(Wj), n, b)
    got = tnative.hb2st_host(Wt, n, b)
    for name, g, r in zip(("d", "e", "VS", "TAUS"), got, ref):
        np.testing.assert_array_equal(g, r, err_msg=name)
    # ranged calls (7 sweeps a range) with the uploads overlapped
    ranged = tnative.hb2st_host_device(Wt, n, b, "cpu", chunk_sweeps=7)
    for name, g, r in zip(("d", "e", "VS", "TAUS"), ranged, ref):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("n,b", SHAPES)
def test_wavefront_matches_jax(rng, n, b, dtype):
    Ab = _band(rng, n, b, dtype)
    Wj, Wt = _storage(Ab, b)
    ref = jb.hb2st(Wj, n, b)
    got = tb.hb2st(Wt, n, b)
    tol = 10 * n * EPS * np.abs(Ab).sum(0).max()
    for name, g, r in zip(("d", "e", "u", "VS", "TAUS"), got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype, (name, g.dtype, r.dtype)
        np.testing.assert_allclose(g, r, rtol=0, atol=tol, err_msg=name)
    d, e, u = got[0].numpy(), got[1].numpy(), got[2].numpy()
    assert (np.abs(np.abs(u) - 1) < 1e-14).all()
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    err = np.abs(np.linalg.eigvalsh(Ab) - np.linalg.eigvalsh(T)).max()
    assert err < 1e-12 * max(np.abs(Ab).max(), 1), err


def test_wavefront_leaves_its_input(rng):
    Ab = _band(rng, 30, 4)
    _, Wt = _storage(Ab, 4)
    before = Wt.clone()
    tb.hb2st(Wt, 30, 4)
    assert torch.equal(Wt, before)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_wavefront_back_transform(rng, dtype):
    """Port hb2st + eigh of its tridiagonal + the port's unmtr_hb2st
    (with the phase u) are eigenpairs of the band."""
    n, b = 45, 6
    Ab = _band(rng, n, b, dtype)
    _, Wt = _storage(Ab, b)
    d, e, u, VS, TAUS = tb.hb2st(Wt, n, b)
    T = np.diag(d.numpy()) + np.diag(e.numpy(), 1) + np.diag(e.numpy(), -1)
    wT, ZT = np.linalg.eigh(T)
    Zin = torch.from_numpy((u.numpy()[:, None] * ZT).astype(dtype))
    Z = tb.unmtr_hb2st(VS, TAUS, Zin, n, b).numpy()
    assert np.abs(Ab @ Z - Z * wT[None, :]).max() < 1e-12 * np.abs(Ab).max()
    assert np.abs(Z.conj().T @ Z - np.eye(n)).max() < 1e-12


@pytest.mark.parametrize(
    "n,b,dtype,trans",
    [
        (45, 6, np.float64, False),
        (45, 6, np.complex128, False),
        (45, 6, np.float64, True),
        (64, 16, np.float64, False),  # n_sweeps not divisible by b
        (37, 5, np.complex128, True),
        (30, 2, np.float64, False),  # minimal bandwidth
        (24, 4, np.float64, False),
    ],
)
def test_unmtr_hb2st_matches_jax(rng, n, b, dtype, trans):
    """Both back-transforms, on the JAX package's reflectors, against the
    JAX package's diamond apply and its per-sweep reference."""
    Ab = _band(rng, n, b, dtype)
    Wj, _ = _storage(Ab, b)
    _, _, _, VS, TAUS = jb.hb2st(Wj, n, b)
    Z0 = rng.standard_normal((n, 13))
    if np.dtype(dtype).kind == "c":
        Z0 = Z0 + 1j * rng.standard_normal((n, 13))
    Z0 = Z0.astype(dtype)
    ref = np.asarray(jb.unmtr_hb2st(VS, TAUS, jnp.asarray(Z0), n, b, trans=trans))
    ref_sweep = np.asarray(jb._unmtr_hb2st_sweep(VS, TAUS, jnp.asarray(Z0), n, b, trans=trans))
    args = (torch.tensor(np.asarray(VS)), torch.tensor(np.asarray(TAUS)), torch.from_numpy(Z0))
    got = tb.unmtr_hb2st(*args, n, b, trans=trans).numpy()
    got_sweep = tb._unmtr_hb2st_sweep(*args, n, b, trans=trans).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_sweep, ref_sweep, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, got_sweep, rtol=0, atol=1e-12)


def test_unmtr_hb2st_placeholder_identity(rng):
    """b <= 1 skips the chase; the placeholder VS back-transforms as the
    identity, as in the JAX package."""
    n, b = 10, 1
    _, Wt = _storage(_band(rng, n, b), b)
    _, _, _, VS, TAUS = tb.hb2st(Wt, n, b)
    Z0 = torch.from_numpy(rng.standard_normal((n, 3)))
    assert torch.equal(tb.unmtr_hb2st(VS, TAUS, Z0, n, b), Z0)


def test_unmtr_hb2st_trans_inverts(rng):
    n, b = 32, 4
    _, Wt = _storage(_band(rng, n, b), b)
    _, _, _, VS, TAUS = tb.hb2st(Wt, n, b)
    Z0 = torch.from_numpy(rng.standard_normal((n, 5)))
    Z2 = tb.unmtr_hb2st(VS, TAUS, tb.unmtr_hb2st(VS, TAUS, Z0, n, b), n, b, trans=True)
    np.testing.assert_allclose(Z2.numpy(), Z0.numpy(), atol=1e-12)


@pytest.mark.parametrize("n", [8, 33, 100])
def test_bisection_matches_jax(rng, n):
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    ref = np.asarray(jb.tridiag_eigvals_bisect(jnp.asarray(d), jnp.asarray(e)))
    got = tb.tridiag_eigvals_bisect(torch.from_numpy(d), torch.from_numpy(e)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2 * n * EPS * np.abs(ref).max())
    wref = np.linalg.eigvalsh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1))
    np.testing.assert_allclose(got, wref, atol=1e-12 * max(1, np.abs(wref).max()))
    assert (np.diff(got) >= -1e-14).all()


def test_bisection_clustered():
    d = np.concatenate([np.zeros(5), np.ones(5), np.ones(5) + 1e-9])
    e = np.full(14, 1e-12)
    ref = np.asarray(jb.tridiag_eigvals_bisect(jnp.asarray(d), jnp.asarray(e)))
    got = tb.tridiag_eigvals_bisect(torch.from_numpy(d), torch.from_numpy(e)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2 * 15 * EPS * np.abs(ref).max())
    wref = np.linalg.eigvalsh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1))
    np.testing.assert_allclose(got, wref, atol=1e-10)
