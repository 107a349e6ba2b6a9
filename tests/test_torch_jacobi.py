"""Port parity: the parallel-order Jacobi polish of slate_tpu_torch
(``ops/jacobi.py``: ``jacobi_eigh_polish``, ``jacobi_svd_polish``,
``eigh_accurate``, ``svd_accurate``) against the JAX package on the CPU,
at the JAX tests' shapes and starting bases (tests/test_jacobi.py: the
library basis a 1e-7 rotation away).

The port reaches the JAX tests' bounds (residual 1e-13, orthogonality
1e-13 / 1e-12), its values agree with the JAX package's within
``50 n eps max|ref|``, and the polished vectors with the JAX package's
within 1e-11 (the same sweeps on the same input: no sign or cluster
freedom is left once both start from one basis)."""

import numpy as np
import pytest
import torch

from slate_tpu.ops import jacobi as jj
from slate_tpu_torch.ops import jacobi as tj

torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps


def _perturbed_basis(rng, V, scale=1e-7):
    n = V.shape[0]
    E = rng.standard_normal((n, n)) * scale
    if np.iscomplexobj(V):
        E = E + 1j * rng.standard_normal((n, n)) * scale
    Q, _ = np.linalg.qr(V + V @ E)
    return Q


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _eigh_case(rng, n, complex_):
    A = rng.standard_normal((n, n))
    if complex_:
        A = A + 1j * rng.standard_normal((n, n))
    S = (A + A.conj().T) / 2
    _, V_ref = np.linalg.eigh(S)
    return S, _perturbed_basis(rng, V_ref)


@pytest.mark.parametrize("n,complex_", [(16, False), (50, False), (65, False), (40, True)])
def test_eigh_polish_matches_jax(rng, n, complex_):
    S, V0 = _eigh_case(rng, n, complex_)
    w, V = (x.numpy() for x in tj.jacobi_eigh_polish(_t(S), _t(V0)))
    wj, Vj = (np.asarray(x) for x in jj.jacobi_eigh_polish(S, V0))
    assert np.abs(S @ V - V * w[None, :]).max() / max(np.abs(S).max(), 1) < 1e-13
    assert np.abs(V.conj().T @ V - np.eye(n)).max() < 1e-13
    np.testing.assert_allclose(w, wj, rtol=0, atol=50 * n * EPS * np.abs(wj).max())
    np.testing.assert_allclose(V, Vj, rtol=0, atol=1e-11)


def test_eigh_polish_values_only(rng):
    """want_vectors=False leaves V0's columns unrotated (in the values'
    order), as in the JAX package."""
    S, V0 = _eigh_case(rng, 30, False)
    w, V = tj.jacobi_eigh_polish(_t(S), _t(V0), want_vectors=False)
    wj, Vj = jj.jacobi_eigh_polish(S, V0, want_vectors=False)
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(S), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(V.numpy(), np.asarray(Vj))


def test_eigh_polish_clustered(rng):
    n = 32
    w_true = np.sort(np.concatenate([np.ones(8), np.ones(8) + 1e-12,
                                     rng.standard_normal(16) * 10]))
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    S = (Q * w_true[None, :]) @ Q.T
    S = (S + S.T) / 2
    V0 = _perturbed_basis(rng, Q)
    w, V = (x.numpy() for x in tj.jacobi_eigh_polish(_t(S), _t(V0)))
    wj, _ = (np.asarray(x) for x in jj.jacobi_eigh_polish(S, V0))
    assert np.abs(S @ V - V * w[None, :]).max() / np.abs(S).max() < 1e-12
    np.testing.assert_allclose(w, wj, rtol=0, atol=50 * n * EPS * np.abs(wj).max())


@pytest.mark.parametrize("n,complex_", [(16, False), (50, False), (24, True)])
def test_svd_polish_matches_jax(rng, n, complex_):
    A = rng.standard_normal((n, n))
    if complex_:
        A = A + 1j * rng.standard_normal((n, n))
    _, s_ref, Vh_ref = np.linalg.svd(A)
    V0 = _perturbed_basis(rng, Vh_ref.conj().T)
    U, s, V = (x.numpy() for x in tj.jacobi_svd_polish(_t(A), _t(V0)))
    Uj, sj, Vj = (np.asarray(x) for x in jj.jacobi_svd_polish(A, V0))
    assert np.abs((U * s[None, :]) @ V.conj().T - A).max() / np.abs(A).max() < 1e-13
    assert np.abs(U.conj().T @ U - np.eye(n)).max() < 1e-12
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=1e-12 * s_ref.max())
    np.testing.assert_allclose(s, sj, rtol=0, atol=50 * n * EPS * sj.max())
    np.testing.assert_allclose(U, Uj, rtol=0, atol=1e-11)
    np.testing.assert_allclose(V, Vj, rtol=0, atol=1e-11)


def test_accurate_wrappers_cpu_passthrough(rng):
    """On the CPU the wrappers are the library calls, as the JAX
    package's are on its CPU backend."""
    n = 20
    A = rng.standard_normal((n, n))
    S = (A + A.T) / 2
    w, V = tj.eigh_accurate(_t(S))
    wj, _ = jj.eigh_accurate(S)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=0, atol=1e-12)
    w2, none = tj.eigh_accurate(_t(S), vectors=False)
    assert none is None
    np.testing.assert_allclose(w2.numpy(), np.linalg.eigvalsh(S), rtol=0, atol=1e-12)
    U, s, Vh = tj.svd_accurate(_t(A))
    np.testing.assert_allclose(s.numpy(), np.asarray(jj.svd_accurate(A)[1]), rtol=0, atol=1e-12)
    np.testing.assert_allclose((U.numpy() * s.numpy()) @ Vh.numpy(), A, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tj.svd_accurate(_t(A), compute_uv=False).numpy(),
                               np.linalg.svd(A, compute_uv=False), rtol=0, atol=1e-12)


def test_round_robin_matches_jax():
    for n in (2, 8, 66):
        np.testing.assert_array_equal(tj._round_robin(n), jj._round_robin(n))
