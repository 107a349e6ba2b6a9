"""Port parity: the Hermitian eigensolver drivers of slate_tpu_torch
(``drivers/eig.py``: ``he2hb``, ``unmtr_he2hb``, ``heev``,
``heev_staged``, ``sterf``/``steqr``/``stedc``, ``hegst``, ``hegv``,
``sygv``; the ``eig``/``eig_vals`` verbs) against the JAX package on the
CPU, at the JAX tests' shapes (tests/test_eig_svd.py).

Bounds, with eps the dtype's unit roundoff:
* he2hb's band, V and T within ``50 n eps ||A||_1`` of the JAX
  package's; ``unmtr_he2hb`` on the JAX package's factors (carried over
  by ``he2hb_from_reference``) within ``50 n eps ||C||_1`` of its own;
* heev's eigenvalues within ``10 n eps ||A||_1`` of ``eigvalsh``;
  ||AZ - Z Lambda||_1 / (||A||_1 n eps) <= 100 and
  ||Z^H Z - I||_1 / (n eps) <= 100 (tools/validate_onchip.py:151's
  bounds); Z_port^H Z_jax a signed (phased) identity within 1e-8 on the
  eigenvalues separated by more than 1e-3 ||A||_1 from their
  neighbours;
* hegv: ||AX - BX Lambda||_1 / (||A||_1 ||X||_1 n eps) <= 100.
The hb2st route taken (native host chaser or device wavefront) is read
from the ``heev.hb2st.*`` counters.  JAX results are computed once a
case in module-scoped caches."""

import functools

import numpy as np
import pytest
import torch

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu.drivers import eig as je
from slate_tpu_torch import simplified as tsimp
from slate_tpu_torch.aux import metrics
from slate_tpu_torch.convert import he2hb_from_reference
from slate_tpu_torch.drivers import eig as te
from slate_tpu_torch.ops.hopper import panel_kernels as pk

torch.set_num_threads(1)

CPU = stt.ProcessGrid.single("cpu")
SEED = 42  # the JAX tests' rng fixture: their first draw is _herm(SEED, ...)
BISECT = {stt.Option.MethodEig: stt.MethodEig.Bisection}


@pytest.fixture(autouse=True)
def _metrics_no_launches():
    was = metrics.is_on()
    metrics.on()
    pk.reset_launches()
    yield
    assert all(v == 0 for v in pk.LAUNCHES.values()), pk.LAUNCHES  # CPU: plain versions
    if not was:
        metrics.off()


def _eps(dtype):
    return np.finfo(dtype).eps


def _herm(seed, n, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        A = A + 1j * rng.standard_normal((n, n))
    return ((A + A.conj().T) / 2).astype(dtype)


def _n1(M):
    return np.abs(M).sum(0).max()


def _np(x):
    if hasattr(x, "to_global"):
        x = x.to_global()
    return x.resolve_conj().numpy() if torch.is_tensor(x) else np.asarray(x)


def _jm(A0, nb):
    return st.HermitianMatrix.from_global(A0, nb, uplo=st.Uplo.Lower)


def _tm(A0, nb):
    return stt.HermitianMatrix.from_global(A0, nb, grid=CPU)


@functools.lru_cache(maxsize=None)
def _jax_he2hb(seed, n, nb, dtype):
    band, V, T = je.he2hb(_jm(_herm(seed, n, dtype), nb))
    return band, V, T


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("n,nb", [(48, 16), (33, 8)])
def test_he2hb_matches_jax(dtype, n, nb):
    A0 = _herm(SEED, n, dtype)
    band, V, T = te.he2hb(_tm(A0, nb))
    jband, jV, jT = _jax_he2hb(SEED, n, nb, dtype)
    tol = 50 * n * _eps(dtype) * _n1(A0)
    assert isinstance(band, stt.HermitianBandMatrix) and band.kd == nb
    for name, got, ref in (("band", band, jband), ("V", V, jV), ("T", T.T, jT.T)):
        got, ref = _np(got), np.asarray(ref.to_global() if hasattr(ref, "to_global") else ref)
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=name)
    B = _np(band)
    i, j = np.meshgrid(range(n), range(n), indexing="ij")
    assert np.abs(B[np.abs(i - j) > nb]).max() == 0


@pytest.mark.parametrize("side,op", [("Left", "NoTrans"), ("Left", "ConjTrans"),
                                     ("Right", "NoTrans"), ("Right", "ConjTrans")])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("n,nb", [(48, 16), (33, 8)])
def test_unmtr_he2hb_on_jax_factors(dtype, n, nb, side, op):
    jband, jV, jT = _jax_he2hb(SEED, n, nb, dtype)
    band, V, T = he2hb_from_reference(np.asarray(jband.data), np.asarray(jV.data),
                                      np.asarray(jT.T), n=n, nb=nb, device="cpu")
    np.testing.assert_array_equal(_np(band), np.asarray(jband.to_global()))
    rng = np.random.default_rng(2)
    shape = (n, 7) if side == "Left" else (7, n)
    C0 = rng.standard_normal(shape) + (1j * rng.standard_normal(shape) if dtype == np.complex128
                                       else 0)
    C0 = C0.astype(dtype)
    ref = np.asarray(je.unmtr_he2hb(st.Side[side], st.Op[op], jV, jT,
                                    st.Matrix.from_global(C0, nb)).to_global())
    got = _np(te.unmtr_he2hb(stt.Side[side], stt.Op[op], V, T,
                             stt.Matrix.from_global(C0, nb, grid=CPU)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=50 * n * _eps(dtype) * _n1(C0))


def test_he2hb_back_transform_reproduces_a():
    n, nb = 32, 8
    A0 = _herm(SEED, n)
    band, V, T = te.he2hb(_tm(A0, nb))
    Q = _np(te.unmtr_he2hb(stt.Side.Left, stt.Op.NoTrans, V, T,
                           stt.Matrix.from_global(np.eye(n), nb, grid=CPU)))
    np.testing.assert_allclose(Q @ Q.T, np.eye(n), atol=1e-12)
    np.testing.assert_allclose(Q @ _np(band) @ Q.T, A0, atol=1e-12)


# (n, nb, dtype, method): two-stage (n > 4 nb), the dense-band path
# (n <= 4 nb), ragged tiles, MethodEig.Bisection.  The two-stage cases
# share n = 80, so the JAX package compiles its stage-3 shapes once
HEEV = {
    "two_stage": (80, 8, np.float64, None),
    "two_stage_c128": (80, 8, np.complex128, None),
    "two_stage_ragged": (80, 12, np.float64, None),
    "dense_band": (48, 16, np.float64, None),
    "dense_band_c128": (48, 16, np.complex128, None),
    "ragged_50_16": (50, 16, np.float64, None),
    "ragged_23_8": (23, 8, np.float64, None),
    "bisection": (80, 8, np.float64, "bisection"),
    "bisection_c128": (80, 8, np.complex128, "bisection"),
}


@functools.lru_cache(maxsize=None)
def _jax_heev(case):
    n, nb, dtype, method = HEEV[case]
    opts = {st.Option.MethodEig: st.MethodEig.Bisection} if method else None
    w, Z = je.heev(_jm(_herm(SEED, n, dtype), nb), opts)
    return np.asarray(w), np.asarray(Z.to_global())


def _route(d):
    return {k: d.get(f"heev.hb2st.{k}") for k in ("host", "device") if d.get(f"heev.hb2st.{k}")}


def _heev_checks(A0, w, Z, dtype):
    n = A0.shape[0]
    eps, a1 = _eps(dtype), _n1(A0)
    wref = np.linalg.eigvalsh(A0.astype(np.complex128 if np.dtype(dtype).kind == "c"
                                        else np.float64))
    assert np.abs(w - wref).max() <= 10 * n * eps * a1, np.abs(w - wref).max() / (n * eps * a1)
    if Z is not None:
        res = _n1(A0 @ Z - Z * w[None, :]) / (a1 * n * eps)
        orth = _n1(Z.conj().T @ Z - np.eye(n)) / (n * eps)
        assert res <= 100 and orth <= 100, (res, orth)
    return wref


@pytest.mark.parametrize("case", list(HEEV))
def test_heev_matches_jax(case):
    n, nb, dtype, method = HEEV[case]
    A0 = _herm(SEED, n, dtype)
    opts = BISECT if method else None
    with metrics.deltas() as d:
        w, Z = stt.heev(_tm(A0, nb), opts)
        route = _route(d)
    w, Z = _np(w), _np(Z)
    assert Z.dtype == dtype and w.dtype == np.float64
    wref = _heev_checks(A0, w, Z, dtype)
    two_stage = method is not None or n > 4 * nb
    expect = ({"device": 1} if dtype == np.complex128 else {"host": 1}) if two_stage else {}
    assert route == expect, route
    wj, Zj = _jax_heev(case)
    np.testing.assert_allclose(w, wj, rtol=0, atol=10 * n * _eps(dtype) * _n1(A0))
    gaps = np.diff(wref)
    gap = np.minimum(np.concatenate([[np.inf], gaps]), np.concatenate([gaps, [np.inf]]))
    sep = gap > 1e-3 * _n1(A0)
    P = np.abs(Z.conj().T @ Zj)[np.ix_(sep, sep)]
    np.testing.assert_allclose(P, np.eye(int(sep.sum())), rtol=0, atol=1e-8)
    # values only: the same route, no vectors
    with metrics.deltas() as d:
        wv, none = stt.heev(_tm(A0, nb), opts, vectors=False)
        assert _route(d) == expect
    assert none is None
    _heev_checks(A0, _np(wv), None, dtype)


def test_heev_device_route_without_native(monkeypatch):
    """Without the native library a real float64 heev takes the device
    wavefront, and the counter says so."""
    monkeypatch.setattr(te.native, "hb2st_available", lambda: False)
    A0 = _herm(SEED, 80, np.float64)
    with metrics.deltas() as d:
        w, Z = stt.heev(_tm(A0, 8))
        assert _route(d) == {"device": 1}
    _heev_checks(A0, _np(w), _np(Z), np.float64)
    wj, _ = _jax_heev("two_stage")
    np.testing.assert_allclose(_np(w), wj, rtol=0, atol=10 * 80 * _eps(np.float64) * _n1(A0))


def test_heev_float32_takes_the_device_route():
    """The host chaser is float64 only: float32 runs the wavefront, to
    float32 bounds."""
    A0 = _herm(SEED, 80, np.float32)
    with metrics.deltas() as d:
        w, Z = stt.heev(_tm(A0, 8))
        assert _route(d) == {"device": 1}
    w, Z = _np(w), _np(Z)
    assert w.dtype == np.float32 and Z.dtype == np.float32
    _heev_checks(A0.astype(np.float64), w.astype(np.float64), Z.astype(np.float64), np.float32)


def test_heev_guards_float32_precision(monkeypatch):
    """heev's float32 path goes through the TF32 guard before its first
    product: he2hb checks its global matrix (the panel's products are
    plain ``@``), and every later product calls ``hdot``, which raises
    on a CUDA tensor under TF32."""
    seen = []
    real = te.check_f32_precision

    def spy(*ts):
        seen.append(tuple(t.dtype for t in ts))
        return real(*ts)

    monkeypatch.setattr(te, "check_f32_precision", spy)
    stt.heev(_tm(_herm(SEED, 40, np.float32), 8))
    assert seen == [(torch.float32,)], seen

    def raising(*ts):
        raise RuntimeError("tf32")

    monkeypatch.setattr(te, "check_f32_precision", raising)
    with pytest.raises(RuntimeError, match="tf32"):
        stt.heev(_tm(_herm(SEED, 40, np.float32), 8))


def test_heev_staged_matches_heev():
    A0 = _herm(SEED, 80, np.float64)
    with metrics.deltas() as d:
        w, Z = stt.heev(_tm(A0, 8))
        assert d.get("heev_staged.calls") == 1  # heev's two-stage path
    ws, Zs, times = stt.drivers.heev_staged(_tm(A0, 8))
    assert list(times) == ["he2hb+gather", "hb2st", "stedc+unmtr_hb2st", "unmtr_he2hb"]
    np.testing.assert_array_equal(_np(ws), _np(w))
    np.testing.assert_array_equal(_np(Zs), _np(Z))
    wv, none, tv = stt.drivers.heev_staged(_tm(A0, 8), vectors=False)
    assert none is None and list(tv) == ["he2hb+gather", "hb2st", "eigvals"]
    _heev_checks(A0, _np(wv), None, np.float64)
    # n <= 4 nb: heev's dense-band path, no stages
    _, _, t_small = stt.drivers.heev_staged(_tm(_herm(SEED, 48, np.float64), 16))
    assert t_small == {}


def test_tridiagonal_drivers_match_jax():
    rng = np.random.default_rng(32)
    n = 80
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    dt, et = torch.from_numpy(d), torch.from_numpy(e)
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    ref = np.linalg.eigvalsh(T)
    tol = 2 * n * _eps(np.float64) * np.abs(ref).max()
    np.testing.assert_allclose(_np(te.sterf(dt, et)), np.asarray(je.sterf(d, e)), rtol=0, atol=tol)
    for method in ("dc", "stein"):
        w, Z = te.steqr(dt, et, method=method)
        wj, Zj = je.steqr(d, e, method=method)
        np.testing.assert_allclose(_np(w), np.asarray(wj), rtol=0, atol=tol)
        Z, Zj = _np(Z), np.asarray(Zj)
        assert np.abs(T @ Z - Z * _np(w)[None, :]).max() < 1e-10
        np.testing.assert_allclose(np.abs(Z.T @ Zj), np.eye(n), rtol=0, atol=1e-8)
    w2, none = te.stedc(dt, et, vectors=False)
    assert none is None
    np.testing.assert_allclose(_np(w2), ref, rtol=0, atol=1e-12)
    w3, none = te.steqr(dt, et, vectors=False)
    np.testing.assert_array_equal(_np(w3), _np(w2))
    wd, Zd = te.stedc(dt, et)
    wdj, _ = je.stedc(d, e)
    np.testing.assert_allclose(_np(wd), np.asarray(wdj), rtol=0, atol=tol)


def _spd(seed, n, dtype=np.float64):
    rng = np.random.default_rng(seed)
    B0 = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        B0 = B0 + 1j * rng.standard_normal((n, n))
    return (B0 @ B0.conj().T + n * np.eye(n)).astype(dtype)


@pytest.mark.parametrize("itype", [1, 2])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_hegst_matches_jax(itype, dtype):
    n, nb = 32, 8
    A0, B0 = _herm(11, n, dtype), _spd(12, n, dtype)
    L, info = stt.potrf(_tm(B0, nb))
    jL, _ = st.potrf(_jm(B0, nb))
    C = te.hegst(itype, _tm(A0, nb), L)
    Cj = je.hegst(itype, _jm(A0, nb), jL)
    got, ref = _np(C.full_global()), np.asarray(Cj.full_global())
    np.testing.assert_allclose(got, ref, rtol=0, atol=50 * n * _eps(dtype) * _n1(ref))
    Lg = np.tril(_np(L))
    expect = (np.linalg.solve(Lg, np.linalg.solve(Lg, A0).conj().T).conj().T if itype == 1
              else Lg.conj().T @ A0 @ Lg)
    np.testing.assert_allclose(got, expect, rtol=0, atol=50 * n * _eps(dtype) * _n1(expect))


@pytest.mark.parametrize("routine", ["hegv", "sygv"])
@pytest.mark.parametrize("n,nb", [(32, 8), (80, 8)])  # dense-band, two-stage
def test_hegv_matches_jax(routine, n, nb):
    rng = np.random.default_rng(SEED)  # the JAX test's draws, in its order
    A0 = rng.standard_normal((n, n))
    A0 = (A0 + A0.T) / 2
    B0 = rng.standard_normal((n, n))
    B0 = B0 @ B0.T + n * np.eye(n)
    w, X, info = getattr(stt, routine)(1, _tm(A0, nb), _tm(B0, nb))
    wj, Xj, infoj = getattr(je, routine)(1, _jm(A0, nb), _jm(B0, nb))
    assert int(info) == 0 == int(infoj)
    w, X = _np(w), _np(X)
    eps = _eps(np.float64)
    r = _n1(A0 @ X - (B0 @ X) * w[None, :]) / (_n1(A0) * _n1(X) * n * eps)
    assert r <= 100, r
    wref = np.linalg.eigvals(np.linalg.solve(B0, A0)).real
    np.testing.assert_allclose(w, np.sort(wref), rtol=0, atol=1e-10 * np.abs(wref).max())
    np.testing.assert_allclose(w, np.asarray(wj), rtol=0, atol=10 * n * eps * np.abs(w).max())
    np.testing.assert_allclose(np.abs(X), np.abs(np.asarray(Xj.to_global())), rtol=0, atol=1e-10)
    wv, none, _ = getattr(stt, routine)(1, _tm(A0, nb), _tm(B0, nb), vectors=False)
    assert none is None
    np.testing.assert_allclose(_np(wv), w, rtol=0, atol=10 * n * eps * np.abs(w).max())


def test_eig_verbs():
    A0 = _herm(SEED, 80, np.float64)
    w, Z = tsimp.eig(_tm(A0, 8))
    w0, Z0 = stt.heev(_tm(A0, 8))
    np.testing.assert_array_equal(_np(w), _np(w0))
    np.testing.assert_array_equal(_np(Z), _np(Z0))
    wv = tsimp.eig_vals(_tm(A0, 8))
    np.testing.assert_array_equal(_np(wv), _np(stt.heev(_tm(A0, 8), vectors=False)[0]))
