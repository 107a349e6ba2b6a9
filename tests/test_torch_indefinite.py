"""Port parity: Aasen's LTL^H (``ops/aasen.py``) and the
Hermitian-indefinite drivers (``hetrf``/``hetrs``/``hesv`` with the
pivot-free LDL^H, the Aasen refactor and the random-butterfly refactor)
of slate_tpu_torch, and their verbs, against the JAX package on the CPU.

The same seeded numpy operands go through both packages, at the shapes
of tests/test_band_indefinite.py.  ``aasen_ltl``'s L, alpha, beta and
perm are bitwise equal (the same numpy code on the same input); both
packages take the same route (pivot-free, ``L._aasen`` or ``L._rbt``);
L and d agree within ``200 n eps max|ref|``, X within ``2000 n eps
max|ref|`` (hesv's refinement sweeps and the butterfly's transforms).
The JAX package's traced-info tests have no counterpart: the port has
no trace.  JAX results are computed once a case in module-scoped
fixtures."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu.drivers import indefinite as jind
from slate_tpu.ops import aasen as jaasen
from slate_tpu_torch import simplified as tsimp
from slate_tpu_torch.drivers import indefinite as tind
from slate_tpu_torch.exceptions import NumericalError
from slate_tpu_torch.ops import aasen as taasen
from slate_tpu_torch.ops.hopper import panel_kernels as pk

torch.set_num_threads(1)

CPU = stt.ProcessGrid.single("cpu")
EPS = np.finfo(np.float64).eps


def _close(got, ref, n, c):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_allclose(got, ref, rtol=0, atol=c * n * EPS * float(np.abs(ref).max()))


def _np(x):
    if hasattr(x, "to_global"):
        x = x.to_global()
    return x.resolve_conj().numpy() if torch.is_tensor(x) else np.asarray(x)


def _route(L):
    return ("aasen" if getattr(L, "_aasen", None) is not None
            else "rbt" if getattr(L, "_rbt", None) is not None else "nopiv")


@pytest.fixture(autouse=True)
def _no_launches():
    pk.reset_launches()
    yield
    assert all(v == 0 for v in pk.LAUNCHES.values()), pk.LAUNCHES  # CPU: plain versions


def _sym(rng, n, cplx=False):
    A = rng.standard_normal((n, n))
    if cplx:
        A = A + 1j * rng.standard_normal((n, n))
    return (A + A.conj().T) / 2


def _operand(name, n):
    """tests/test_band_indefinite.py's operands (and the phase-14 one)."""
    rng = np.random.default_rng(n)
    if name == "indefinite":
        return _sym(rng, n)
    if name == "definite":
        return _sym(rng, n) + n * np.eye(n)
    if name == "complex":
        return _sym(rng, n, True)
    if name == "kron":
        return np.kron(np.eye(n // 2), np.array([[0.0, 1.0], [1.0, 0.0]]))
    if name == "kron_complex":
        return np.kron(np.eye(n // 2), np.array([[0, 1j], [-1j, 0]])).astype(complex)
    if name == "near_singular":
        A = _sym(rng, n) + np.diag(np.abs(rng.standard_normal(n)) + 1)
        A[0, 0] = 1e-13
        return A
    if name == "chain":
        return np.diag(np.ones(n - 1), 1) + np.diag(np.ones(n - 1), -1)
    if name == "signs":  # the card's hesv operand: pivot-free, no breakdown
        s = np.where(rng.standard_normal(n) >= 0, 1.0, -1.0)
        return _sym(rng, n) + 3 * np.sqrt(n) * np.diag(s)
    raise ValueError(name)


# -- Aasen's LTL^H on the host ------------------------------------------------


@pytest.mark.parametrize("name,n", [("indefinite", 64), ("complex", 48), ("chain", 32),
                                    ("kron", 32), ("kron_complex", 16), ("indefinite", 1),
                                    ("indefinite", 2)])
def test_aasen_bitwise_equal_to_jax(name, n):
    A = _operand(name, n)
    ref = jaasen.aasen_ltl(A)
    got = taasen.aasen_ltl(A)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
        assert np.asarray(g).dtype == np.asarray(r).dtype
    L, al, be, perm, _ = got
    B = np.random.default_rng(n + 1).standard_normal((n, 3)).astype(A.dtype)
    np.testing.assert_array_equal(taasen.tridiag_solve_piv(al, be, B),
                                  jaasen.tridiag_solve_piv(al, be, B))
    X = taasen.aasen_solve(L, al, be, perm, B)
    np.testing.assert_array_equal(X, jaasen.aasen_solve(L, al, be, perm, B))
    assert np.abs(A @ X - B).max() < 1e-10 * max(n, 1)


# -- the drivers --------------------------------------------------------------

HESV_CASES = [("indefinite", 40, 8, "auto"), ("complex", 24, 8, "auto"),
              ("kron", 32, 8, "auto"), ("kron_complex", 16, 8, "auto"),
              ("near_singular", 32, 8, "auto"), ("chain", 32, 8, "auto"),
              ("indefinite", 64, 16, "aasen"), ("complex", 48, 16, "aasen"),
              ("kron", 32, 8, "rbt"), ("kron_complex", 16, 8, "rbt"),
              ("signs", 96, 32, "auto")]


@pytest.fixture(scope="module", params=HESV_CASES, ids=lambda c: "-".join(map(str, c)))
def hesv_case(request):
    """hetrf(method) + hetrs of both packages, and hesv for "auto"."""
    name, n, nb, method = request.param
    A = _operand(name, n)
    rng = np.random.default_rng(n + 7)
    B = rng.standard_normal((n, 3))
    if np.iscomplexobj(A):
        B = B + 1j * rng.standard_normal((n, 3))
    out = {}
    for pkg, mod, grid in ((st, jind, {}), (stt, tind, {"grid": CPU})):
        x = jnp.asarray if pkg is st else torch.from_numpy
        Am = pkg.HermitianMatrix.from_global(x(A), nb, uplo=pkg.Uplo.Lower, **grid)
        Bm = pkg.Matrix.from_global(x(B), nb, **grid)
        L, d, info = mod.hetrf(Am, method=method)
        res = {"L": L, "d": d, "info": int(info), "X_hetrs": mod.hetrs(L, d, Bm)}
        if method == "auto":
            res["hesv"] = mod.hesv(Am, Bm)
        out["jax" if pkg is st else "port"] = res
    return (name, n, nb, method, A, B), out["jax"], out["port"]


def test_hetrf_route_and_info_equal_jax(hesv_case):
    (name, n, _, method, *_), ref, got = hesv_case
    assert _route(got["L"]) == _route(ref["L"])
    assert got["info"] == ref["info"]
    if method != "auto":
        assert _route(got["L"]) == method
    elif name in ("kron", "kron_complex", "near_singular", "chain"):
        assert _route(got["L"]) == "aasen"  # the pivot-free pass breaks down
    elif name == "signs":
        assert _route(got["L"]) == "nopiv" and got["info"] == 0
    assert isinstance(got["info"], int) and torch.is_tensor(got["d"])


def test_hetrf_factor_matches_jax(hesv_case):
    (_, n, _, method, *_), ref, got = hesv_case
    Lg, Lr = _np(got["L"]), np.asarray(ref["L"].to_global())
    if _route(got["L"]) == "aasen":  # the same numpy factor on both sides
        np.testing.assert_array_equal(Lg, Lr)
        np.testing.assert_array_equal(_np(got["d"]), np.asarray(ref["d"]))
        for g, r in zip(got["L"]._aasen, ref["L"]._aasen):
            np.testing.assert_array_equal(g, r)
        return
    c = 2000 if method == "rbt" else 200
    _close(Lg, Lr, Lg.shape[0], c)
    _close(_np(got["d"]), np.asarray(ref["d"]), Lg.shape[0], c)
    if method == "rbt":
        du, n_got = got["L"]._rbt
        assert n_got == ref["L"]._rbt[1]
        _close(_np(du), np.asarray(ref["L"]._rbt[0]), n, 1)


def test_hetrs_and_hesv_match_jax(hesv_case):
    (name, n, _, method, A, B), ref, got = hesv_case
    _close(_np(got["X_hetrs"]), np.asarray(ref["X_hetrs"].to_global()), n, 2000)
    if method != "auto":
        return
    X, L, d, info = got["hesv"]
    Xr, Lr, _, info_r = ref["hesv"]
    assert int(info) == int(info_r) and _route(L) == _route(Lr)
    _close(_np(X), np.asarray(Xr.to_global()), n, 2000)
    assert np.abs(A @ _np(X) - B).max() < 1e-9 * n * max(np.abs(A).max(), 1.0)


def test_hetrf_factorization_reconstructs():
    """tests/test_band_indefinite.py::test_hetrf_factorization: L D L^T."""
    n = 24
    A = _operand("definite", n)
    L, d, info = tind.hetrf(stt.HermitianMatrix.from_global(A, 8, grid=CPU))
    assert int(info) == 0 and _route(L) == "nopiv"
    Lg = np.tril(_np(L), -1) + np.eye(n)
    np.testing.assert_allclose(Lg @ np.diag(_np(d)) @ Lg.T, A, atol=1e-9)


# -- the verbs ----------------------------------------------------------------


def test_indefinite_verbs_dispatch():
    """indefinite_factor / indefinite_solve / indefinite_solve_using_factor
    are hetrf / hesv / hetrs (the same calls, bit for bit)."""
    n, nb = 40, 8
    A, B = _operand("indefinite", n), np.random.default_rng(1).standard_normal((n, 2))
    Am = stt.HermitianMatrix.from_global(A, nb, grid=CPU)
    Bm = stt.Matrix.from_global(B, nb, grid=CPU)
    L, d, info = tind.hetrf(Am)
    Lv, dv, infov = tsimp.indefinite_factor(Am)
    np.testing.assert_array_equal(_np(Lv), _np(L))
    np.testing.assert_array_equal(_np(dv), _np(d))
    np.testing.assert_array_equal(_np(tsimp.indefinite_solve(Am, Bm)), _np(tind.hesv(Am, Bm)[0]))
    np.testing.assert_array_equal(_np(tsimp.indefinite_solve_using_factor(L, d, Bm)),
                                  _np(tind.hetrs(L, d, Bm)))


def test_indefinite_solve_raises_on_breakdown(monkeypatch):
    """The verb returns only X, so a nonzero info raises NumericalError
    (as the JAX package's eager verb does); a breakdown that the Aasen
    refactor absorbs (info 0) solves."""
    n, nb = 16, 8
    A = _operand("kron", n)
    B = np.random.default_rng(2).standard_normal((n, 2))
    Am = stt.HermitianMatrix.from_global(A, nb, grid=CPU)
    Bm = stt.Matrix.from_global(B, nb, grid=CPU)
    X = tsimp.indefinite_solve(Am, Bm)
    assert np.abs(A @ _np(X) - B).max() < 1e-8
    real = tind.hesv

    def broken(*a, **k):
        X, L, d, _ = real(*a, **k)
        return X, L, d, torch.ones((), dtype=torch.int32)

    monkeypatch.setattr(tind, "hesv", broken)
    with pytest.raises(NumericalError, match="breakdown"):
        tsimp.indefinite_solve(Am, Bm)
    monkeypatch.setattr(jind, "hesv", lambda *a, **k: (None, None, None, jnp.ones((), jnp.int32)))
    with pytest.raises(Exception, match="breakdown"):
        st.simplified.indefinite_solve(
            st.HermitianMatrix.from_global(jnp.asarray(A), nb), st.Matrix.from_global(jnp.asarray(B), nb))
