"""Port parity: the inverses (``trtri``, ``trtrm``, ``potri``,
``tri_inv_blocked``), the condition estimators (``norm1est``,
``pocondest``, ``gecondest``, ``trcondest``), ``chol_fori`` and the
rank-k Cholesky up/downdate of slate_tpu_torch against the JAX package
on the CPU.

The same seeded numpy inputs go through both packages.  Tolerance:
``50 n eps max|ref|`` for matrices, as in tests/test_torch_blas.py; each
estimate equals the JAX package's within 1e-12 relative and lies within
the JAX tests' bounds (ref <= rcond <= 3 ref, tests/test_lu.py:210 and
tests/test_chol.py:152)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu.drivers import chol as jchol
from slate_tpu.drivers import lu as jlu
from slate_tpu.internal import norm1est as jne
from slate_tpu.ops import chol_kernels as jck
from slate_tpu_torch.drivers import chol as tchol
from slate_tpu_torch.drivers import lu as tlu
from slate_tpu_torch.internal import norm1est as tne
from slate_tpu_torch.ops import chol_kernels as tck

torch.set_num_threads(1)

CPU = stt.ProcessGrid.single("cpu")


def _tol(n, ref):
    return 50 * n * np.finfo(np.float64).eps * max(float(np.abs(ref).max()), 1.0)


def _close(got, ref, n):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=_tol(n, ref))


def _data(rng, m, n, cplx):
    a = rng.standard_normal((m, n))
    return a + 1j * rng.standard_normal((m, n)) if cplx else a


def _spd(rng, n, cplx=False):
    g = _data(rng, n, n, cplx)
    return g @ g.conj().T + n * np.eye(n)


def _views(op):
    return ({"NoTrans": lambda M: M, "Trans": st.transpose, "ConjTrans": st.conj_transpose}[op],
            {"NoTrans": lambda M: M, "Trans": stt.transpose,
             "ConjTrans": stt.conj_transpose}[op])


def _tri_pair(a, nb, grid11, uplo, diag="NonUnit", op="NoTrans"):
    jv, tv = _views(op)
    J = st.TriangularMatrix.from_global(jnp.asarray(a), nb, grid=grid11, uplo=st.Uplo[uplo],
                                        diag=st.Diag[diag])
    T = stt.TriangularMatrix.from_global(a, nb, grid=CPU, uplo=stt.Uplo[uplo],
                                         diag=stt.Diag[diag])
    return jv(J), tv(T)


def _tri_operand(rng, n, cplx, uplo):
    a = _data(rng, n, n, cplx) * 0.3 + np.diag(2.0 + np.abs(rng.standard_normal(n)))
    return np.tril(a) if uplo == "Lower" else np.triu(a)


def _rel(got, ref):
    return abs(float(got) - float(ref)) / abs(float(ref))


# ---------------------------------------------------------------------------
# inverses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("uplo,diag,op", list(itertools.product(
    ["Lower", "Upper"], ["NonUnit", "Unit"], ["NoTrans", "Trans", "ConjTrans"])))
@pytest.mark.parametrize("cplx", [False, True])
def test_trtri_matches_jax(uplo, diag, op, cplx, grid11):
    n, nb = 40, 16
    rng = np.random.default_rng(len(uplo) + 3 * len(diag) + 5 * len(op) + cplx)
    a = _tri_operand(rng, n, cplx, uplo)
    a = a + (np.triu(_data(rng, n, n, cplx), 1) if uplo == "Lower"
             else np.tril(_data(rng, n, n, cplx), -1))  # junk in the other triangle
    J, T = _tri_pair(a, nb, grid11, uplo, diag, op)
    ref, got = jchol.trtri(J), tchol.trtri(T)
    assert (got.uplo.name, got.diag.name) == (ref.uplo.name, ref.diag.name)
    assert isinstance(got, stt.TriangularMatrix) and got.layout == T.layout
    _close(got.to_global().numpy(), ref.to_global(), n)


@pytest.mark.parametrize("uplo,diag,op,cplx", [("Lower", "NonUnit", "NoTrans", False),
                                               ("Upper", "Unit", "Trans", True)])
def test_trtri_above_nb_inverts_through_tri_inv_blocked(uplo, diag, op, cplx, grid11,
                                                        monkeypatch):
    """At n = 600 trtri recurses once in tri_inv_blocked (nb 512: the
    JAX split 384, two leaf solves) and still matches the JAX package's
    solve against the identity; a unit diagonal ignores the stored one."""
    n, nb = 600, 64
    rng = np.random.default_rng(600 + cplx)
    L = np.linalg.cholesky(_spd(rng, n, cplx))
    if diag == "Unit":
        L = L / np.diag(L)[None, :]
        L[np.diag_indices(n)] = 5.0
    a = L if uplo == "Lower" else L.conj().T
    calls = []
    inner = tck.tri_inv_blocked
    monkeypatch.setattr(tck, "tri_inv_blocked", lambda *a_, **k: calls.append(1) or inner(*a_, **k))
    J, T = _tri_pair(a, nb, grid11, uplo, diag, op)
    ref, got = jchol.trtri(J), tchol.trtri(T)
    assert len(calls) == 3
    assert got.uplo.name == ref.uplo.name
    _close(got.to_global().numpy(), ref.to_global(), n)


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("op", ["NoTrans", "Trans"])
@pytest.mark.parametrize("cplx", [False, True])
def test_trtrm_and_potri_match_jax(uplo, op, cplx, grid11):
    """potri of a potrf factor (and of a transposed view of it, which
    trtri inverts into the other triangle) and trtrm on its own."""
    n, nb = 48, 16
    rng = np.random.default_rng(len(uplo) + 7 * len(op) + cplx)
    s = _spd(rng, n, cplx)
    JA = st.HermitianMatrix.from_global(jnp.asarray(s), nb, grid=grid11, uplo=st.Uplo[uplo])
    TA = stt.HermitianMatrix.from_global(s, nb, grid=CPU, uplo=stt.Uplo[uplo])
    JL, _ = st.potrf(JA)
    TL, _ = stt.potrf(TA)
    jv, tv = _views(op)
    ref, got = jchol.trtrm(jv(JL)), tchol.trtrm(tv(TL))
    assert isinstance(got, stt.HermitianMatrix) and got.uplo.name == ref.uplo.name
    _close(got.to_global().numpy(), ref.to_global(), n)
    ref, got = jchol.potri(jv(JL)), tchol.potri(tv(TL))
    assert got.uplo.name == ref.uplo.name
    _close(got.full_global().numpy(), ref.full_global(), n)
    if op == "NoTrans":  # the inverse of A itself
        _close(got.full_global().numpy(), np.linalg.inv(s), n)


@pytest.mark.parametrize("n,nb", [(100, 512), (200, 64), (300, 64), (129, 128)])
def test_tri_inv_blocked_matches_jax(n, nb):
    """At and below nb one library solve; above, the recursion with the
    JAX package's split (half rounded up to 128)."""
    rng = np.random.default_rng(n + nb)
    a = np.tril(rng.standard_normal((n, n))) * 0.3 + np.diag(2.0 + rng.random(n))
    a = a + np.triu(rng.standard_normal((n, n)), 1)  # never read
    ref = np.asarray(jck.tri_inv_blocked(jnp.asarray(a), nb))
    got = tck.tri_inv_blocked(torch.from_numpy(a), nb).numpy()
    _close(got, ref, n)
    np.testing.assert_array_equal(np.triu(got, 1), 0)


@pytest.mark.parametrize("n,nb", [(512, 128), (768, 256), (256, 256)])
def test_chol_fori_matches_jax(n, nb):
    """tests/test_chol_kernels.py::test_chol_fori's shapes, and n == nb."""
    rng = np.random.default_rng(n)
    s = _spd(rng, n)
    ref = np.asarray(jck.chol_fori(jnp.asarray(s), nb))
    got = tck.chol_fori(torch.from_numpy(s), nb).numpy()
    _close(got, ref, n)
    _close(got, np.linalg.cholesky(s), n)


def test_chol_fori_complex_matches_jax():
    s = _spd(np.random.default_rng(5), 256, True)
    ref = np.asarray(jck.chol_fori(jnp.asarray(s), 128))
    _close(tck.chol_fori(torch.from_numpy(s), 128).numpy(), ref, 256)


# ---------------------------------------------------------------------------
# rank-k up/downdate (tests/test_factor_cache.py:226-266)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("downdate", [False, True])
def test_chol_rank1_update_matches_jax(cplx, downdate):
    n = 24
    rng = np.random.default_rng(11 + cplx + 2 * downdate)
    s = _spd(rng, n, cplx)
    u = _data(rng, n, 1, cplx)[:, 0] * 0.5
    L = np.linalg.cholesky(s)
    ref = np.asarray(jck.chol_rank1_update(jnp.asarray(L), jnp.asarray(u), downdate))
    got = tck.chol_rank1_update(torch.from_numpy(L), torch.from_numpy(u), downdate).numpy()
    _close(got, ref, n)
    sign = -1.0 if downdate else 1.0
    _close(got, np.linalg.cholesky(s + sign * np.outer(u, u.conj())), n)


@pytest.mark.parametrize("cplx", [False, True])
def test_chol_update_rank2_and_downdate_match_jax(cplx):
    n = 20
    rng = np.random.default_rng(21 + cplx)
    s = _spd(rng, n, cplx)
    U = _data(rng, n, 2, cplx)
    L = np.linalg.cholesky(s)
    jup = jck.chol_update(jnp.asarray(L), jnp.asarray(U))
    tup = tck.chol_update(torch.from_numpy(L), torch.from_numpy(U))
    _close(tup.numpy(), jup, n)
    _close(tup.numpy(), np.linalg.cholesky(s + U @ U.conj().T), n)
    jdown = np.asarray(jck.chol_update(jup, jnp.asarray(U), downdate=True))
    tdown = tck.chol_update(tup, torch.from_numpy(U), downdate=True).numpy()
    _close(tdown, jdown, n)
    np.testing.assert_allclose(tdown, L, rtol=0, atol=1e-8)
    # a vector U is one rank-1 sweep
    _close(tck.chol_update(torch.from_numpy(L), torch.from_numpy(U[:, 0])).numpy(),
           jck.chol_update(jnp.asarray(L), jnp.asarray(U[:, 0])), n)


def test_chol_downdate_breakdown_yields_nan():
    L = np.eye(8)
    u = np.zeros(8)
    u[0] = 2.0  # A - u u^T is indefinite
    got = tck.chol_rank1_update(torch.from_numpy(L), torch.from_numpy(u), downdate=True)
    ref = np.asarray(jck.chol_rank1_update(jnp.asarray(L), jnp.asarray(u), downdate=True))
    assert not torch.isfinite(got).all()
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))


# ---------------------------------------------------------------------------
# condition estimators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("kind", ["random", "diag", "alternating"])
def test_norm1est_matches_jax(cplx, kind):
    """Explicit B: the estimate and the iteration path (the stopping
    test, the first argmax) equal the JAX package's."""
    n = 30
    rng = np.random.default_rng(len(kind) + cplx)
    if kind == "random":
        b = _data(rng, n, n, cplx)
    elif kind == "diag":  # the uniform start is already the maximizer
        b = np.diag(np.arange(1.0, n + 1)).astype(complex if cplx else float)
    else:  # a structure the alternating-sign vector catches
        b = np.tile(np.array([1.0, -1.0] * (n // 2)), (n, 1)).astype(complex if cplx else float)
    jbm, tbm = jnp.asarray(b), torch.from_numpy(b)
    ref = jne.norm1est(lambda x: jbm @ x, lambda x: jbm.conj().T @ x, n, jbm.dtype)
    got = tne.norm1est(lambda x: tbm @ x, lambda x: tbm.mH @ x, n, tbm.dtype, device="cpu")
    assert got.dtype == torch.float64 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-12)
    assert float(got) <= np.abs(b).sum(0).max() * (1 + 1e-12)


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("cplx", [False, True])
def test_pocondest_matches_jax(uplo, cplx, grid11):
    n, nb = 32, 8
    rng = np.random.default_rng(31 + len(uplo) + cplx)
    s = _spd(rng, n, cplx)
    s = s * np.sqrt(np.outer(np.logspace(0, 1, n), np.logspace(0, 1, n)))  # graded, still SPD
    JA = st.HermitianMatrix.from_global(jnp.asarray(s), nb, grid=grid11, uplo=st.Uplo[uplo])
    TA = stt.HermitianMatrix.from_global(s, nb, grid=CPU, uplo=stt.Uplo[uplo])
    anorm = float(stt.norm(stt.Norm.One, TA))
    JL, _ = st.potrf(JA)
    TL, _ = stt.potrf(TA)
    ref = float(jchol.pocondest(JL, anorm))
    got = tchol.pocondest(TL, anorm)
    assert got.dim() == 0
    assert _rel(got, ref) < 1e-12, (float(got), ref)
    exact = 1.0 / (np.linalg.norm(s, 1) * np.linalg.norm(np.linalg.inv(s), 1))
    assert exact * 0.999 <= float(got) <= 3.0 * exact, (float(got), exact)


def test_pocondest_of_a_singular_factor_is_zero():
    L = stt.TriangularMatrix.from_global(np.diag([1.0, 0.0, 1.0, 1.0]), 2, grid=CPU)
    assert float(tchol.pocondest(L, 1.0)) == 0.0


@pytest.mark.parametrize("norm_type", ["One", "Inf"])
@pytest.mark.parametrize("cplx", [False, True])
def test_gecondest_matches_jax(norm_type, cplx, grid11):
    n, nb = 48, 16
    rng = np.random.default_rng(41 + len(norm_type) + cplx)
    a = _data(rng, n, n, cplx) @ np.diag(np.logspace(0, 2, n)) + 0.5 * n * np.eye(n)
    ord_ = 1 if norm_type == "One" else np.inf
    anorm = np.linalg.norm(a, ord_)
    JLU, jpiv, _ = st.getrf(st.Matrix.from_global(jnp.asarray(a), nb, grid=grid11))
    TLU, tpiv, _ = stt.getrf(stt.Matrix.from_global(a, nb, grid=CPU))
    np.testing.assert_array_equal(tpiv.perm.numpy(), np.asarray(jpiv.perm))
    ref = float(jlu.gecondest(JLU, jpiv, anorm, st.Norm[norm_type]))
    got = tlu.gecondest(TLU, tpiv, anorm, stt.Norm[norm_type])
    assert _rel(got, ref) < 1e-12, (float(got), ref)
    exact = 1.0 / (anorm * np.linalg.norm(np.linalg.inv(a), ord_))
    assert exact <= float(got) * (1 + 1e-12) and float(got) <= 3.0 * exact, (float(got), exact)


@pytest.mark.parametrize("uplo,op,diag", list(itertools.product(
    ["Lower", "Upper"], ["NoTrans", "Trans", "ConjTrans"], ["NonUnit", "Unit"])))
@pytest.mark.parametrize("norm_type", ["One", "Inf"])
@pytest.mark.parametrize("cplx", [False, True])
def test_trcondest_matches_jax(uplo, op, diag, norm_type, cplx, grid11):
    n, nb = 40, 16
    rng = np.random.default_rng(len(uplo) + 3 * len(op) + 5 * len(diag) + 7 * len(norm_type)
                                + cplx)
    a = _tri_operand(rng, n, cplx, uplo)
    if diag == "Unit":
        a = a - np.diag(np.diag(a)) + np.diag(rng.standard_normal(n))  # never read
    J, T = _tri_pair(a, nb, grid11, uplo, diag, op)
    ref = float(jlu.trcondest(J, st.Norm[norm_type]))
    got = tlu.trcondest(T, stt.Norm[norm_type])
    assert _rel(got, ref) < 1e-12, (float(got), ref)
    t = T.to_global().resolve_conj().numpy()
    if diag == "Unit":
        t = t - np.diag(np.diag(t)) + np.eye(n)
    t = np.tril(t) if (uplo == "Lower") == (op == "NoTrans") else np.triu(t)
    ord_ = 1 if norm_type == "One" else np.inf
    exact = 1.0 / (np.linalg.norm(t, ord_) * np.linalg.norm(np.linalg.inv(t), ord_))
    assert exact * 0.999 <= float(got) <= 3.0 * exact, (float(got), exact)
