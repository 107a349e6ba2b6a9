"""hegst / hegv / sygv of slate_tpu_torch for every itype and both uplos
of A and of B, against scipy's generalized eigensolver (LAPACK
zhegv / dsygv) on the CPU.

The JAX package's hegst applies the Lower formulas to an Upper factor and
back-transforms x = L^-H y for every itype; the port follows LAPACK, so
these cases are held against scipy rather than against the JAX package
(``tests/test_torch_eig.py`` keeps the JAX parity for itype 1 with a
Lower B).  The triangle of A and of B that the uplo does not name is
filled with junk, so a routine that read it would fail.

Gates (PERF.md section 2): eigenvalues within 10 n eps max(||A||_1,
||C||_2) of scipy's, C the reduced standard matrix, whose 2-norm is the
largest |lambda|: ||A||_1 bounds it for itype 1, while for itype 2 and 3
the spectrum of L^H A L grows with ||B||, and its rounding with it; the
scaled residual of each itype ||A X - B X L||_1 /
(||A||_1 ||X||_1 n eps), ||A B X - X L||_1 / (||A||_1 ||B||_1 ||X||_1 n
eps) and ||B A X - X L||_1 / (||A||_1 ||B||_1 ||X||_1 n eps) <= 100.
"""

import numpy as np
import pytest
import scipy.linalg as sl
import torch

import slate_tpu_torch as stt
from slate_tpu_torch.drivers import eig as te

torch.set_num_threads(1)

CPU = stt.ProcessGrid.single("cpu")
NB = 8


def _herm(seed, n, dtype):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        A = A + 1j * rng.standard_normal((n, n))
    return ((A + A.conj().T) / 2).astype(dtype)


def _spd(seed, n, dtype):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        G = G + 1j * rng.standard_normal((n, n))
    return (G @ G.conj().T + n * np.eye(n)).astype(dtype)


def _stored(M, uplo, seed):
    """M's ``uplo`` triangle (diagonal included) with junk in the other."""
    junk = np.random.default_rng(seed).standard_normal(M.shape) * 7 + 3
    if uplo == "L":
        return np.tril(M) + np.triu(junk, 1)
    return np.triu(M) + np.tril(junk, -1)


def _uplo(c):
    return stt.Uplo.Lower if c == "L" else stt.Uplo.Upper


def _tm(M, uplo, seed):
    return stt.HermitianMatrix.from_global(_stored(M, uplo, seed), NB, grid=CPU,
                                           uplo=_uplo(uplo))


def _n1(M):
    return np.abs(M).sum(0).max()


def _np(x):
    if hasattr(x, "to_global"):
        x = x.to_global()
    return x.resolve_conj().numpy()


@pytest.mark.parametrize("n", [32, 80])  # dense-band, two-stage
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("uplo_b", ["L", "U"])
@pytest.mark.parametrize("uplo_a", ["L", "U"])
@pytest.mark.parametrize("itype", [1, 2, 3])
def test_hegv_matches_scipy(itype, uplo_a, uplo_b, dtype, n):
    A0, B0 = _herm(1, n, dtype), _spd(2, n, dtype)
    routine = stt.sygv if np.dtype(dtype).kind == "f" else stt.hegv
    w, X, info = routine(itype, _tm(A0, uplo_a, 3), _tm(B0, uplo_b, 4))
    assert int(info) == 0
    w, X = _np(w), _np(X)
    eps = np.finfo(np.float64).eps
    wref = sl.eigh(A0, B0, type=itype, lower=uplo_b == "L", eigvals_only=True)
    wtol = 10 * n * eps * max(_n1(A0), np.abs(wref).max())
    np.testing.assert_allclose(w, wref, rtol=0, atol=wtol)
    if itype == 1:
        R, scale = A0 @ X - (B0 @ X) * w, _n1(A0) * _n1(X)
    elif itype == 2:
        R, scale = A0 @ (B0 @ X) - X * w, _n1(A0) * _n1(B0) * _n1(X)
    else:
        R, scale = B0 @ (A0 @ X) - X * w, _n1(A0) * _n1(B0) * _n1(X)
    r = _n1(R) / (scale * n * eps)
    assert r <= 100, r
    wv, none, _ = routine(itype, _tm(A0, uplo_a, 3), _tm(B0, uplo_b, 4), vectors=False)
    assert none is None
    np.testing.assert_allclose(_np(wv), wref, rtol=0, atol=wtol)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("uplo_b", ["L", "U"])
@pytest.mark.parametrize("itype", [1, 2, 3])
def test_hegst_lapack_formulas(itype, uplo_b, dtype):
    """C = L^-1 A L^-H / L^H A L for B = L L^H, and U^-H A U^-1 /
    U A U^H for B = U^H U, with the factor potrf returns for B's uplo."""
    n = 32
    A0, B0 = _herm(5, n, dtype), _spd(6, n, dtype)
    F, info = stt.potrf(_tm(B0, uplo_b, 7))
    assert int(info) == 0 and F.uplo == _uplo(uplo_b)
    C = _np(te.hegst(itype, _tm(A0, "L", 8), F).full_global())
    Fg = _np(F)
    if uplo_b == "L":
        Lg = np.tril(Fg)
        expect = (np.linalg.solve(Lg, np.linalg.solve(Lg, A0).conj().T).conj().T
                  if itype == 1 else Lg.conj().T @ A0 @ Lg)
    else:
        Ug = np.triu(Fg)
        expect = (np.linalg.solve(Ug.conj().T, np.linalg.solve(Ug.conj().T, A0).conj().T)
                  .conj().T if itype == 1 else Ug @ A0 @ Ug.conj().T)
    eps = np.finfo(np.float64).eps
    np.testing.assert_allclose(C, expect, rtol=0, atol=50 * n * eps * _n1(expect))
