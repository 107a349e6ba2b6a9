"""Port parity: the divide and conquer tridiagonal eigensolver of
slate_tpu_torch (``ops/stedc.py``) against the JAX package on the CPU.

The JAX tests' matrices (tests/test_stedc.py: random, Toeplitz,
identity, near identity, Wilkinson, glued Wilkinson, clustered, scaled
tiny, mixed scale) go through both packages.  The port holds to the
JAX tests' bounds (wtol 5e-13 on the eigenvalues, vtol 5e-12 on the
residual and the orthogonality, all relative to max|lambda|), its
eigenvalues agree with the JAX package's within wtol, and its vectors
equal the JAX package's up to sign wherever the eigenvalue is separated
from its neighbours by more than 1e-3 max|lambda| (within a cluster
any orthonormal basis of the invariant subspace is right)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.ops.stedc import stedc as jstedc
from slate_tpu_torch.ops.stedc import stedc as tstedc

torch.set_num_threads(1)

WTOL, VTOL = 5e-13, 5e-12


def _wilkinson(m=10):
    return np.abs(np.arange(-m, m + 1)).astype(float), np.ones(2 * m)


def _glued(m=10):
    dw, _ = _wilkinson(m)
    dg = np.concatenate([dw] * 4)
    eg = np.ones(len(dg) - 1)
    eg[len(dw) - 1:: len(dw)] = 1e-8
    return dg, eg


def _case(name):
    if name.startswith("random"):
        n = int(name[6:])
        rng = np.random.default_rng(n)
        return rng.standard_normal(n), rng.standard_normal(max(n - 1, 0))
    rng = {"clustered": 7, "scaled_tiny": 3, "mixed_scale": 5}.get(name)
    rng = np.random.default_rng(rng) if rng is not None else None
    return {
        "toeplitz": lambda: (np.zeros(96), np.ones(95)),
        "identity": lambda: (np.ones(64), np.zeros(63)),
        "near_identity": lambda: (np.ones(64), 1e-14 * np.ones(63)),
        "wilkinson": _wilkinson,
        "glued_wilkinson": _glued,
        "clustered": lambda: (np.repeat(rng.standard_normal(8), 8),
                              1e-13 * rng.standard_normal(63)),
        "scaled_tiny": lambda: (1e-20 * rng.standard_normal(48),
                                1e-20 * rng.standard_normal(47)),
        "mixed_scale": lambda: (np.concatenate([1e8 * np.ones(24), 1e-8 * np.ones(24)])
                                * rng.standard_normal(48), rng.standard_normal(47)),
    }[name]()


CASES = [f"random{n}" for n in (1, 2, 3, 5, 16, 64, 100)] + [
    "toeplitz", "identity", "near_identity", "wilkinson", "glued_wilkinson", "clustered",
    "scaled_tiny", "mixed_scale"]


@pytest.mark.parametrize("name", CASES)
def test_stedc_matches_jax(name):
    d, e = _case(name)
    n = d.shape[0]
    w, Q = tstedc(torch.from_numpy(d), torch.from_numpy(e))
    w, Q = w.numpy(), Q.numpy()
    assert w.dtype == np.float64 and Q.shape == (n, n)
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    wref = np.linalg.eigvalsh(T)
    scale = max(np.abs(wref).max(), 1e-30)
    assert np.abs(w - wref).max() / scale < WTOL
    assert np.abs(T @ Q - Q * w[None, :]).max() / scale < VTOL
    assert np.abs(Q.T @ Q - np.eye(n)).max() < VTOL
    wj, Qj = jax.jit(jstedc)(jnp.asarray(d), jnp.asarray(e))
    wj, Qj = np.asarray(wj), np.asarray(Qj)
    assert np.abs(w - wj).max() / scale < WTOL
    gaps = np.diff(wj)
    gap = np.minimum(np.concatenate([[np.inf], gaps]), np.concatenate([gaps, [np.inf]]))
    sep = gap > 1e-3 * scale
    sign = np.where((Q * Qj).sum(0) < 0, -1.0, 1.0)
    np.testing.assert_allclose((Q * sign)[:, sep], Qj[:, sep], rtol=0, atol=VTOL)


def test_stedc_batches_each_level():
    """A level's merges run as one batch: the tree of n = 16 calls the
    merge once a level (4 levels), whatever the number of merges."""
    import slate_tpu_torch.ops.stedc as ts

    calls = []
    orig = ts._merge

    def spy(w1, *a):
        calls.append(w1.shape[0])
        return orig(w1, *a)

    rng = np.random.default_rng(16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ts, "_merge", spy)
        ts.stedc(torch.from_numpy(rng.standard_normal(16)),
                 torch.from_numpy(rng.standard_normal(15)))
    assert calls == [8, 4, 2, 1]


@pytest.mark.parametrize("n", [80, 160, 300, 600])
def test_stedc_padding_keeps_the_residual(n):
    """A non-power-of-two n is padded to N = 2^k with decoupled poles.
    Their magnitude enters every merge's deflation tolerance, so the
    port keeps them within 3 bound: each eigenvector's residual stays
    within 10 n eps ||T||_1, as for a power-of-two n.  With the JAX
    package's pads, up to (N - n + 1) bound, these cases exceed it."""
    rng = np.random.default_rng(n)
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    w, Q = tstedc(torch.from_numpy(d), torch.from_numpy(e))
    w, Q = w.numpy(), Q.numpy()
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    eps = np.finfo(np.float64).eps
    col = np.abs(T @ Q - Q * w[None, :]).sum(0) / (np.abs(T).sum(0).max() * n * eps)
    assert col.max() <= 10, col.max()
    assert np.abs(Q.T @ Q - np.eye(n)).sum(0).max() / (n * eps) <= 10
    np.testing.assert_allclose(w, np.linalg.eigvalsh(T), rtol=0,
                               atol=50 * eps * np.abs(T).sum(0).max())
