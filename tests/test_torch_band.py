"""Port parity: the band kinds, the windowed band kernels and the band
drivers of slate_tpu_torch (``BandMatrix`` / ``TriangularBandMatrix`` /
``HermitianBandMatrix``; ``band_potrf_lower``, ``band_trsm_lower``,
``band_getrf``, ``band_getrs``; ``gbmm``, ``hbmm``, ``tbsm``,
``gbtrf``/``gbtrs``/``gbsv``, ``pbtrf``/``pbtrs``/``pbsv``) and their
verbs against the JAX package on the CPU.

The same seeded numpy operands go through both packages, at the JAX
tests' shapes (tests/test_band_kernels.py, tests/test_band_indefinite.py).
``band_getrf``'s perm, lperms and w are exactly equal; every L, LU and X
agrees within ``200 n eps max|ref|``; and both packages take the same
route (the windowed kernels or the dense drivers), counted by spies on
the band kernels of each package.  JAX results are computed once a case
in module-scoped fixtures."""

import collections
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu.drivers import band as jband
from slate_tpu.matrix.base import transpose as jtranspose
from slate_tpu.ops import band_kernels as jbk
from slate_tpu_torch import simplified as tsimp
from slate_tpu_torch.convert import matrix_from_reference, pivots_from_reference
from slate_tpu_torch.drivers import band as tband
from slate_tpu_torch.exceptions import SlateError
from slate_tpu_torch.matrix.base import transpose as ttranspose
from slate_tpu_torch.ops import band_kernels as tbk
from slate_tpu_torch.ops.hopper import panel_kernels as pk

torch.set_num_threads(1)

CPU = stt.ProcessGrid.single("cpu")
EPS = np.finfo(np.float64).eps
KERNELS = ("band_potrf_lower", "band_trsm_lower", "band_getrf", "band_getrs")


def _close(got, ref, n, c=200):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_allclose(got, ref, rtol=0, atol=c * n * EPS * float(np.abs(ref).max()))


def _np(x):
    if hasattr(x, "to_global"):
        x = x.to_global()
    return x.resolve_conj().numpy() if torch.is_tensor(x) else np.asarray(x)


@contextlib.contextmanager
def _spy(mod):
    """Count the calls of mod's band kernels (the route a driver took)."""
    calls = collections.Counter()
    with pytest.MonkeyPatch.context() as mp:
        for name in KERNELS:
            def counted(*a, _fn=getattr(mod, name), _name=name, **k):
                calls[_name] += 1
                return _fn(*a, **k)
            mp.setattr(mod, name, counted)
        yield calls


@pytest.fixture(autouse=True)
def _no_launches():
    pk.reset_launches()
    yield
    assert all(v == 0 for v in pk.LAUNCHES.values()), pk.LAUNCHES  # CPU: plain versions


def _spd_band(rng, n, kd, dtype=np.float64):
    """A Hermitian band with kd sub- and superdiagonals, SPD by strict
    diagonal dominance (a random band + (2 kd + 2) I, the JAX tests'
    operand, is not SPD for every seed at kd = 1)."""
    i = np.arange(n)
    mask = np.abs(i[:, None] - i[None, :]) <= kd
    A = rng.standard_normal((n, n)).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        A = A + 1j * rng.standard_normal((n, n))
    S = (A + A.conj().T) / 2 * mask
    return S + np.diag(np.abs(S).sum(axis=1) + 2 * kd + 2)


def _gen_band(rng, n, kl, ku):
    i = np.arange(n)
    mask = ((i[None, :] - i[:, None]) <= ku) & ((i[:, None] - i[None, :]) <= kl)
    return (rng.standard_normal((n, n)) + 2 * np.eye(n)) * mask


def _tri_band(rng, n, kd, uplo_lower):
    i = np.arange(n)
    if uplo_lower:
        mask = (i[:, None] - i[None, :] <= kd) & (i[:, None] >= i[None, :])
    else:
        mask = (i[None, :] - i[:, None] <= kd) & (i[:, None] <= i[None, :])
    return rng.standard_normal((n, n)) * mask + (n + 2) * np.eye(n)


# -- the matrix kinds ---------------------------------------------------------


@pytest.mark.parametrize("m,n,kl,ku,nb", [(32, 32, 3, 2, 8), (45, 37, 5, 0, 16),
                                          (40, 40, 0, 7, 16)])
def test_band_matrix_from_global_and_mask_match_jax(m, n, kl, ku, nb):
    A = np.random.default_rng(m + kl).standard_normal((m, n))
    J = st.BandMatrix.from_global(jnp.asarray(A), kl, ku, nb)
    T = stt.BandMatrix.from_global(A, kl, ku, nb, grid=CPU)
    assert (T.kl, T.ku) == (kl, ku)
    np.testing.assert_array_equal(T.data.numpy(), np.asarray(J.data))
    np.testing.assert_array_equal(T.band_mask().numpy(), np.asarray(J.band_mask()))
    # the kinds survive _with and transposition
    assert (ttranspose(T).kl, T._with(op=stt.Op.Trans).ku) == (kl, ku)


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
def test_band_kinds_match_jax(uplo):
    n, kd, nb = 30, 4, 8
    H = _spd_band(np.random.default_rng(3), n, kd)
    Jm, Tm = st.Matrix.from_global(jnp.asarray(H), nb), stt.Matrix.from_global(H, nb, grid=CPU)
    Jh = st.HermitianBandMatrix(Jm.data, Jm.layout, kd=kd, uplo=st.Uplo[uplo])
    Th = stt.HermitianBandMatrix(Tm.data, Tm.layout, grid=CPU, kd=kd, uplo=stt.Uplo[uplo])
    assert (Th.kl, Th.ku, Th.kd) == (Jh.kl, Jh.ku, Jh.kd)
    np.testing.assert_array_equal(_np(Th.full_global()), np.asarray(Jh.full_global()))
    np.testing.assert_array_equal(Th.band_mask().numpy(), np.asarray(Jh.band_mask()))
    T2 = Th._with(op=stt.Op.Trans)
    assert isinstance(T2, stt.HermitianBandMatrix) and (T2.kd, T2.uplo) == (kd, Th.uplo)


# -- the windowed kernels -----------------------------------------------------


@pytest.mark.parametrize("n,kd,dtype", [(200, 8, np.float64), (333, 17, np.float64),
                                        (128, 1, np.float64), (150, 6, np.complex128),
                                        (40, 39, np.float64)])
def test_band_potrf_lower_matches_jax(n, kd, dtype):
    """The JAX kernel tests' shapes, complex, and kd >= n - 1 (one dense
    Cholesky)."""
    A = _spd_band(np.random.default_rng(n + kd), n, kd, dtype)
    ref = np.asarray(jbk.band_potrf_lower(jnp.asarray(A), kd))
    got = tbk.band_potrf_lower(torch.from_numpy(A), kd).numpy()
    _close(got, ref, n)
    i = np.arange(n)
    assert np.abs(got[(i[:, None] < i[None, :]) | (i[:, None] - i[None, :] > kd)]).max() == 0


@pytest.mark.parametrize("n,kd,unit", [(180, 7, False), (255, 16, True)])
def test_band_trsm_lower_matches_jax(n, kd, unit):
    rng = np.random.default_rng(n)
    i = np.arange(n)
    mask = (i[:, None] - i[None, :] <= kd) & (i[:, None] >= i[None, :])
    L = rng.standard_normal((n, n)) * mask * (0.1 / np.sqrt(kd))
    np.fill_diagonal(L, 1.0 if unit else np.abs(L.diagonal()) + n)
    B = rng.standard_normal((n, 5))
    ref = np.asarray(jbk.band_trsm_lower(jnp.asarray(L), jnp.asarray(B), kd, unit_diag=unit))
    got = tbk.band_trsm_lower(torch.from_numpy(L), torch.from_numpy(B), kd, unit_diag=unit)
    _close(got.numpy(), ref, n)


@pytest.fixture(scope="module", params=[(200, 5, 3), (257, 12, 9), (150, 1, 1)],
                ids=lambda p: "x".join(map(str, p)))
def getrf_case(request):
    """band_getrf + band_getrs of both packages on one operand."""
    n, kl, ku = request.param
    rng = np.random.default_rng(n + kl)
    A, B = _gen_band(rng, n, kl, ku), rng.standard_normal((n, 4))
    lu, lperms, perm, w = jbk.band_getrf(jnp.asarray(A), kl, ku)
    X = jbk.band_getrs(lu, lperms, w, kl, ku, jnp.asarray(B))
    ref = tuple(np.asarray(v) for v in (lu, lperms, perm, X)) + (w,)
    t_lu, t_lperms, t_perm, t_w = tbk.band_getrf(torch.from_numpy(A), kl, ku)
    t_X = tbk.band_getrs(t_lu, t_lperms, t_w, kl, ku, torch.from_numpy(B))
    return (n, kl, ku, A, B), ref, (t_lu, t_lperms, t_perm, t_X, t_w)


def test_band_getrf_pivots_equal_jax(getrf_case):
    _, (_, lperms, perm, _, w), (_, t_lperms, t_perm, _, t_w) = getrf_case
    assert t_w == w
    assert t_lperms.dtype == torch.int32 and t_perm.dtype == torch.int32
    np.testing.assert_array_equal(t_lperms.numpy(), lperms)
    np.testing.assert_array_equal(t_perm.numpy(), perm)


def test_band_getrf_lu_and_getrs_match_jax(getrf_case):
    (n, kl, ku, A, B), (lu, _, _, X, w), (t_lu, _, _, t_X, _) = getrf_case
    _close(t_lu.numpy(), lu, n)
    _close(t_X.numpy(), X, n)
    i = np.arange(n)
    U, L = np.triu(t_lu.numpy()), np.tril(t_lu.numpy(), -1)
    assert np.abs(U[(i[None, :] - i[:, None]) > kl + ku]).max() == 0
    assert np.abs(L[(i[:, None] - i[None, :]) >= w + kl]).max() == 0
    assert np.abs(A @ t_X.numpy() - B).max() < 1e-10 * n * np.abs(B).max()


def test_band_getrf_runs_one_panel_a_window(monkeypatch):
    """The window panel goes through lu_kernels._panel_route: one call a
    window at shape (w + kl, w), the route's result used as is (the
    rehearsal of the card's panel_lu launches, ceil(n / w))."""
    n, kl, ku = 300, 40, 20
    A = _gen_band(np.random.default_rng(7), n, kl, ku)
    shapes = []

    def route(dtype, device):
        def panel(p):
            shapes.append(tuple(p.shape))
            return pk.panel_lu_plain(p)
        return panel

    ref = tbk.band_getrf(torch.from_numpy(A), kl, ku)
    monkeypatch.setattr(tbk, "_panel_route", route)
    got = tbk.band_getrf(torch.from_numpy(A), kl, ku)
    w = got[3]
    assert shapes == [(w + kl, w)] * -(-n // w)
    for a, b in zip(got[:3], ref[:3]):
        assert torch.equal(a, b)


# -- the drivers --------------------------------------------------------------


def _mats(A, nb, kind, **kw):
    """The same operand as a JAX and a port matrix of ``kind``."""
    Jm, Tm = st.Matrix.from_global(jnp.asarray(A), nb), stt.Matrix.from_global(A, nb, grid=CPU)
    if kind == "Matrix":
        return Jm, Tm
    jkw = {k: (st.Uplo[v] if k == "uplo" else v) for k, v in kw.items()}
    tkw = {k: (stt.Uplo[v] if k == "uplo" else v) for k, v in kw.items()}
    return (getattr(st, kind)(Jm.data, Jm.layout, **jkw),
            getattr(stt, kind)(Tm.data, Tm.layout, grid=CPU, **tkw))


@pytest.mark.parametrize("op", ["NoTrans", "Trans"])
def test_gbmm_matches_jax(op):
    n, kl, ku = 32, 3, 2
    rng = np.random.default_rng(11)
    A, B = _gen_band(rng, n, kl, ku) + rng.standard_normal((n, n)), rng.standard_normal((n, 8))
    Ja = st.BandMatrix.from_global(jnp.asarray(A), kl, ku, 8)
    Ta = stt.BandMatrix.from_global(A, kl, ku, 8, grid=CPU)
    if op == "Trans":
        Ja, Ta = jtranspose(Ja), ttranspose(Ta)
    Jb, Tb = _mats(B, 8, "Matrix")
    Jc = st.Matrix.zeros(n, 8, 8, dtype=np.float64)
    Tc = stt.Matrix.zeros(n, 8, 8, dtype=torch.float64, grid=CPU)
    ref = np.asarray(jband.gbmm(2.0, Ja, Jb, 0.0, Jc).to_global())
    _close(_np(tband.gbmm(2.0, Ta, Tb, 0.0, Tc)), ref, n)
    _close(_np(tsimp.multiply(2.0, Ta, Tb, 0.0, Tc)), ref, n)
    _close(_np(tsimp.band_multiply(2.0, Ta, Tb, 0.0, Tc)), ref, n)


@pytest.mark.parametrize("uplo,side", [("Lower", "Left"), ("Upper", "Right")])
def test_hbmm_matches_jax(uplo, side):
    n, kd = 24, 3
    rng = np.random.default_rng(12)
    H = _spd_band(rng, n, kd) + 5 * np.triu(rng.standard_normal((n, n)), kd + 2)  # junk outside
    B = rng.standard_normal((n, 6) if side == "Left" else (6, n))
    Ja, Ta = _mats(H, 8, "HermitianBandMatrix", kd=kd, uplo=uplo)
    Jb, Tb = _mats(B, 8, "Matrix")
    Jc, Tc = _mats(np.ones(B.shape), 8, "Matrix")
    ref = np.asarray(jband.hbmm(st.Side[side], 1.5, Ja, Jb, 0.5, Jc).to_global())
    _close(_np(tband.hbmm(stt.Side[side], 1.5, Ta, Tb, 0.5, Tc)), ref, n)


@pytest.fixture(scope="module",
                params=[(48, 4, 3, 8, 10.0), (200, 6, 4, 32, 0.0), (40, 6, 5, 8, 0.0)],
                ids=["narrow48", "narrow200", "wide40"])
def gbsv_case(request):
    """gbsv of both packages (tests/test_band_indefinite.py::test_gbsv's
    operand, test_band_kernels.py::test_gbsv_band_aware's, and a band
    with kl + ku >= n // 4, which takes the dense getrf)."""
    n, kl, ku, nb, shift = request.param
    rng = np.random.default_rng(n + 1)
    A = _gen_band(rng, n, kl, ku) + shift * np.eye(n)
    B = rng.standard_normal((n, 4))
    Ja = st.BandMatrix.from_global(jnp.asarray(A), kl, ku, nb)
    Ta = stt.BandMatrix.from_global(A, kl, ku, nb, grid=CPU)
    Jb, Tb = _mats(B, nb, "Matrix")
    with _spy(jbk) as jroute:
        ref = jband.gbsv(Ja, Jb)
    with _spy(tbk) as troute:
        got = tband.gbsv(Ta, Tb)
    return (n, kl, ku, nb, A, B), ref, got, jroute, troute


def test_gbsv_route_and_pivots_equal_jax(gbsv_case):
    (n, kl, ku, *_), (_, J_lu, J_piv, J_info), (_, T_lu, T_piv, T_info), jr, tr = gbsv_case
    assert tr == jr
    assert (T_piv.band_lperms is None) == (J_piv.band_lperms is None)
    assert (T_piv.band_lperms is None) == (kl + ku >= n // 4)
    np.testing.assert_array_equal(T_piv.perm.numpy(), np.asarray(J_piv.perm))
    if J_piv.band_lperms is not None:
        np.testing.assert_array_equal(T_piv.band_lperms.numpy(), np.asarray(J_piv.band_lperms))
        assert T_piv.band_w == J_piv.band_w
    assert int(T_info) == int(J_info) == 0
    assert (T_lu.kl, T_lu.ku) == (J_lu.kl, J_lu.ku)


def test_gbsv_factor_and_solution_match_jax(gbsv_case):
    (n, _, _, _, A, B), (J_X, J_lu, *_), (T_X, T_lu, *_), *_ = gbsv_case
    _close(_np(T_lu), np.asarray(J_lu.to_global()), n)
    _close(_np(T_X), np.asarray(J_X.to_global()), n)


def test_gbtrs_solves_a_jax_band_factorization(gbsv_case):
    """The port's gbtrs on the JAX package's gbtrf result, carried across
    by convert (tiles, bandwidths, band_lperms / band_w)."""
    (n, _, _, nb, A, B), (J_X, J_lu, J_piv, _), *_ = gbsv_case
    lay = J_lu.layout
    LU = matrix_from_reference(np.asarray(J_lu.data), m=lay.m, n=lay.n, mb=lay.mb, nb=lay.nb,
                               kind="BandMatrix", kl=J_lu.kl, ku=J_lu.ku, device="cpu")
    lp = None if J_piv.band_lperms is None else np.asarray(J_piv.band_lperms)
    piv = pivots_from_reference(np.asarray(J_piv.perm), "cpu", band_lperms=lp,
                                band_w=J_piv.band_w)
    assert isinstance(LU, stt.BandMatrix) and (LU.kl, LU.ku) == (J_lu.kl, J_lu.ku)
    assert (piv.band_lperms is None) == (lp is None) and piv.band_w == J_piv.band_w
    X = tband.gbtrs(LU, piv, stt.Matrix.from_global(B, nb, grid=CPU))
    _close(_np(X), np.asarray(J_X.to_global()), n)
    _close(_np(tsimp.lu_solve_using_factor(LU, piv, stt.Matrix.from_global(B, nb, grid=CPU))),
           np.asarray(J_X.to_global()), n)


@pytest.fixture(scope="module",
                params=[(40, 4, "Lower", 8, np.float64), (192, 9, "Lower", 32, np.float64),
                        (192, 9, "Upper", 32, np.float64), (40, 12, "Lower", 8, np.float64),
                        (64, 5, "Upper", 16, np.complex128)],
                ids=["lower40", "lower192", "upper192", "wide40", "complex64"])
def pbsv_case(request):
    """pbsv of both packages; kd >= n // 4 takes the dense potrf."""
    n, kd, uplo, nb, dtype = request.param
    rng = np.random.default_rng(n + kd)
    A = _spd_band(rng, n, kd, dtype)
    B = rng.standard_normal((n, 4)).astype(dtype)
    stored = np.tril(A) if uplo == "Lower" else np.triu(A)
    Ja, Ta = _mats(stored, nb, "HermitianBandMatrix", kd=kd, uplo=uplo)
    Jb, Tb = _mats(B, nb, "Matrix")
    with _spy(jbk) as jroute:
        ref = jband.pbsv(Ja, Jb)
    with _spy(tbk) as troute:
        got = tband.pbsv(Ta, Tb)
    return (n, kd, uplo, nb, A, B), ref, got, jroute, troute


def test_pbsv_matches_jax(pbsv_case):
    (n, kd, uplo, nb, A, B), (J_X, J_L, J_info), (T_X, T_L, T_info), jr, tr = pbsv_case
    assert tr == jr and bool(tr) == (kd < n // 4)
    assert int(T_info) == int(J_info) == 0
    assert isinstance(T_L, stt.TriangularBandMatrix) and T_L.uplo.name == J_L.uplo.name
    assert (T_L.kd, T_L.kl, T_L.ku) == (J_L.kd, J_L.kl, J_L.ku)
    _close(_np(T_L), np.asarray(J_L.to_global()), n)
    _close(_np(T_X), np.asarray(J_X.to_global()), n)
    assert np.abs(A @ _np(T_X) - B).max() < 1e-11 * np.abs(B).max() * n


def test_band_verbs_dispatch_to_the_band_drivers(pbsv_case):
    """chol_factor / chol_solve / chol_solve_using_factor on the band
    kinds are pbtrf / pbsv / pbtrs (bit for bit: the same call)."""
    (n, kd, uplo, nb, A, B), _, (T_X, T_L, _), *_ = pbsv_case
    stored = np.tril(A) if uplo == "Lower" else np.triu(A)
    _, Ta = _mats(stored, nb, "HermitianBandMatrix", kd=kd, uplo=uplo)
    Tb = stt.Matrix.from_global(B, nb, grid=CPU)
    L, _ = tsimp.chol_factor(Ta)
    assert isinstance(L, stt.TriangularBandMatrix)
    np.testing.assert_array_equal(_np(L), _np(T_L))
    np.testing.assert_array_equal(_np(tsimp.chol_solve(Ta, Tb)), _np(T_X))
    np.testing.assert_array_equal(_np(tsimp.chol_solve_using_factor(T_L, Tb)), _np(T_X))


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("op", ["n", "t"])
@pytest.mark.parametrize("side", ["Left", "Right"])
def test_tbsm_matches_jax(uplo, op, side):
    """tests/test_band_kernels.py::test_tbsm_band_aware's cases."""
    n, kd, nb = 160, 8, 32
    rng = np.random.default_rng(160)
    T0 = _tri_band(rng, n, kd, uplo == "Lower")
    B0 = rng.standard_normal((n, 6) if side == "Left" else (6, n))
    Ja, Ta = _mats(T0, nb, "TriangularBandMatrix", kd=kd, uplo=uplo)
    if op == "t":
        Ja, Ta = jtranspose(Ja), ttranspose(Ta)
    Jb, Tb = _mats(B0, nb, "Matrix")
    with _spy(jbk) as jr:
        ref = np.asarray(jband.tbsm(st.Side[side], 1.0, Ja, Jb).to_global())
    with _spy(tbk) as tr:
        got = _np(tband.tbsm(stt.Side[side], 1.0, Ta, Tb))
    assert tr == jr == {"band_trsm_lower": 1}
    _close(got, ref, n)
    M = T0 if op == "n" else T0.T
    want = np.linalg.solve(M, B0) if side == "Left" else np.linalg.solve(M.T, B0.T).T
    np.testing.assert_allclose(got, want, atol=1e-10)
    np.testing.assert_array_equal(
        _np(tsimp.triangular_solve(1.0, Ta, Tb, side=stt.Side[side])), got)


@pytest.mark.parametrize("kd,unit", [(3, False), (12, True)])
def test_tbsm_small_and_wide_match_jax(kd, unit):
    """tests/test_band_indefinite.py::test_tbsm's operand (narrow) and a
    band with kd >= n // 4 (the dense trsm), alpha != 1, unit diagonal."""
    n = 40
    T0 = _tri_band(np.random.default_rng(kd), n, kd, True)
    if unit:  # keep the unit-diagonal substitution well conditioned
        T0 = np.tril(T0, -1) * (0.1 / np.sqrt(kd)) + (n + 2) * np.eye(n)
    B0 = np.random.default_rng(kd + 1).standard_normal((n, 4))
    diag = "Unit" if unit else "NonUnit"
    Jm, Tm = st.Matrix.from_global(jnp.asarray(T0), 8), stt.Matrix.from_global(T0, 8, grid=CPU)
    Ja = st.TriangularBandMatrix(Jm.data, Jm.layout, kd=kd, uplo=st.Uplo.Lower,
                                 diag=st.Diag[diag])
    Ta = stt.TriangularBandMatrix(Tm.data, Tm.layout, grid=CPU, kd=kd, uplo=stt.Uplo.Lower,
                                  diag=stt.Diag[diag])
    Jb, Tb = _mats(B0, 8, "Matrix")
    with _spy(jbk) as jr:
        ref = np.asarray(jband.tbsm(st.Side.Left, 2.0, Ja, Jb).to_global())
    with _spy(tbk) as tr:
        got = _np(tband.tbsm(stt.Side.Left, 2.0, Ta, Tb))
    assert tr == jr and bool(tr) == (kd < n // 4)
    _close(got, ref, n)


def test_tbsm_refuses_band_pivots():
    """A windowed gbtrf's pivots are solved by gbtrs only: tbsm raises in
    both packages; net-perm pivots of a dense factor are applied."""
    n = 48
    T0 = _tri_band(np.random.default_rng(5), n, 3, True)
    Ja, Ta = _mats(T0, 8, "TriangularBandMatrix", kd=3, uplo="Lower")
    Jb, Tb = _mats(np.ones((n, 2)), 8, "Matrix")
    ident = np.arange(n, dtype=np.int32)
    J_piv = st.Pivots(jnp.asarray(ident), band_lperms=jnp.zeros((2, 40), jnp.int32), band_w=32)
    T_piv = stt.Pivots(torch.from_numpy(ident), band_lperms=torch.zeros((2, 40), dtype=torch.int32),
                       band_w=32)
    with pytest.raises(Exception, match="windowed-gbtrf"):
        jband.tbsm(st.Side.Left, 1.0, Ja, Jb, J_piv)
    with pytest.raises(SlateError, match="windowed-gbtrf"):
        tband.tbsm(stt.Side.Left, 1.0, Ta, Tb, T_piv)
    perm = np.random.default_rng(6).permutation(n)
    ref = jband.tbsm(st.Side.Left, 1.0, Ja, Jb, st.Pivots(jnp.asarray(perm, jnp.int32)))
    got = tband.tbsm(stt.Side.Left, 1.0, Ta, Tb, stt.Pivots(torch.tensor(perm, dtype=torch.int32)))
    _close(_np(got), np.asarray(ref.to_global()), n)


def test_gbsv_on_a_logical_grid_takes_the_dense_route():
    """A band matrix on a 2 x 2 grid runs the dense getrf/getrs and
    potrf/potrs, as the JAX package's distributed inputs do."""
    n, kl, ku, nb = 64, 2, 3, 16
    grid = stt.ProcessGrid(torch.device("cpu"), 2, 2)
    rng = np.random.default_rng(9)
    A, B = _gen_band(rng, n, kl, ku) + 8 * np.eye(n), rng.standard_normal((n, 3))
    Bm = stt.Matrix.from_global(B, nb, grid=grid)
    with _spy(tbk) as tr:
        X, LU, piv, info = tband.gbsv(stt.BandMatrix.from_global(A, kl, ku, nb, grid=grid), Bm)
        S = _spd_band(rng, n, 3)
        Sm = stt.Matrix.from_global(np.tril(S), nb, grid=grid)
        Xs, L, info_s = tband.pbsv(stt.HermitianBandMatrix(Sm.data, Sm.layout, grid=grid, kd=3), Bm)
    assert not tr and piv.band_lperms is None and int(info) == int(info_s) == 0
    np.testing.assert_allclose(_np(X), np.linalg.solve(A, B), atol=1e-10)
    np.testing.assert_allclose(_np(Xs), np.linalg.solve(S, B), atol=1e-10)
    X2 = tsimp.lu_solve(stt.BandMatrix.from_global(A, kl, ku, nb, grid=grid), Bm)
    np.testing.assert_array_equal(_np(X2), _np(X))


def test_wide_pbsv_of_a_band_matrix_without_a_grid_stays_on_its_device():
    """A HermitianBandMatrix built from tiles with no grid (its device is
    its data's) takes the dense potrf there, not on the default grid."""
    n, kd, nb = 40, 12, 8
    S = _spd_band(np.random.default_rng(4), n, kd)
    B = np.random.default_rng(8).standard_normal((n, 2))
    M = stt.Matrix.from_global(np.tril(S), nb, grid=CPU)
    X, L, info = tband.pbsv(stt.HermitianBandMatrix(M.data, M.layout, kd=kd),
                            stt.Matrix.from_global(B, nb, grid=CPU))
    assert int(info) == 0 and L.device.type == "cpu"
    np.testing.assert_allclose(_np(X), np.linalg.solve(S, B), atol=1e-12)


def test_band_and_indefinite_entry_points_are_exported():
    """The JAX package's root exports of this slice (slate_tpu/__init__.py)
    are the port's too."""
    for name in ("BandMatrix", "TriangularBandMatrix", "HermitianBandMatrix", "gbmm", "gbsv",
                 "gbtrf", "gbtrs", "hbmm", "pbsv", "pbtrf", "pbtrs", "tbsm", "hesv", "hetrf",
                 "hetrs"):
        assert hasattr(st, name) and hasattr(stt, name), name
    assert stt.gbsv is tband.gbsv and stt.hesv.__module__ == "slate_tpu_torch.drivers.indefinite"
