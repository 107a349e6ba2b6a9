"""Port parity: the SVD family of slate_tpu_torch (``drivers/svd.py``:
``ge2tb``, ``unmbr_ge2tb_left`` / ``_right``, ``_jw_band_storage``,
``tb2bd``, ``bdsqr``, ``svd``; ``upper_band_diagonals_tiles``; the
``svd`` / ``svd_vals`` verbs) against the JAX package on the CPU, at
the JAX tests' shapes (tests/test_eig_svd.py) and at the shapes that
take the Jordan-Wielandt (JW) route (n <= m, n > 4 (2 nb + 1)).

Bounds, with eps the dtype's unit roundoff:
* ``upper_band_diagonals_tiles`` and ``_jw_band_storage`` bitwise equal
  to the JAX package's on the same tiles;
* ge2tb's band, UV, UT, VV and VT within ``50 n eps ||A||_1`` of the
  JAX package's; ``unmbr_ge2tb_*`` on the JAX package's factors (carried
  over by ``ge2tb_from_reference``) within ``50 n eps ||C||_1``;
* singular values within ``10 max(m, n) eps ||A||_1`` of the JAX
  package's and of numpy's;
  ||A - U S V^H||_1 / (||A||_1 max(m, n) eps) <= 100;
  U_port^H U_ref a phased identity within 1e-8 (1e-3 in float32) on the
  singular values separated by more than 1e-3 ||A||_1 from their
  neighbours;
* ||U^H U - I||_1 / (k eps) <= 100, and the same for V, k = min(m, n).
  The JW split turns the divide and conquer's eigenvector residuals
  into a loss of orthogonality by mixing the +-sigma pairs.  The JAX
  package's stedc pads a JW tridiagonal whose size 2n is not a power of
  two with poles that widen its deflation tolerance, and its U at
  n = 80 can exceed the bound; the port's stedc keeps them small
  (``tests/test_torch_stedc.py``, ROADMAP.md Queue 3), so the port's U
  is held to the bound and to the JAX package's U on the separated
  singular values only.
The hb2st route taken is read from the ``svd.hb2st.*`` counters.  JAX
results are computed once a case in module-scoped caches; the JAX
package's JW route with vectors compiles its divide and conquer for
n = 160, so only one JW case asks it for vectors."""

import functools

import numpy as np
import pytest
import torch

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu.drivers import svd as js
from slate_tpu.parallel import band_gather as jbg
from slate_tpu.parallel.layout import TileLayout as JLayout
from slate_tpu.parallel.layout import tiles_from_global as j_tiles
from slate_tpu_torch import simplified as tsimp
from slate_tpu_torch.aux import metrics
from slate_tpu_torch.convert import ge2tb_from_reference
from slate_tpu_torch.drivers import eig as te
from slate_tpu_torch.drivers import svd as ts
from slate_tpu_torch.ops.hopper import panel_kernels as pk
from slate_tpu_torch.parallel import band_gather as tbg
from slate_tpu_torch.parallel.layout import TileLayout

torch.set_num_threads(1)

CPU = stt.ProcessGrid.single("cpu")
SEED = 42  # the JAX tests' rng fixture: their first draw is _ge(SEED, m, n)


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


def _ge(seed, m, n, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    if np.dtype(dtype).kind == "c":
        A = A + 1j * rng.standard_normal((m, n))
    return A.astype(dtype)


def _n1(M):
    return np.abs(M).sum(0).max()


def _np(x):
    if hasattr(x, "to_global"):
        x = x.to_global()
    return x.resolve_conj().numpy() if torch.is_tensor(x) else np.asarray(x)


def _jm(A0, nb):
    return st.Matrix.from_global(A0, nb)


def _tm(A0, nb):
    return stt.Matrix.from_global(A0, nb, grid=CPU)


def _wide(dtype):
    return np.complex128 if np.dtype(dtype).kind == "c" else np.float64


def _route(d):
    return {k: d.get(f"svd.hb2st.{k}") for k in ("host", "device") if d.get(f"svd.hb2st.{k}")}


# ---------------------------------------------------------------------------
# stage 1: ge2tb, the band gather, the back-transforms
# ---------------------------------------------------------------------------

GE2TB = {  # (m, n, nb, dtype)
    "square": (40, 40, 8, np.float64),  # the JAX test's band-structure shape
    "wide_ragged": (33, 50, 8, np.float64),
    "tall_ragged_c128": (50, 34, 16, np.complex128),
    "one_panel": (19, 8, 8, np.float64),
}


@functools.lru_cache(maxsize=None)
def _jax_ge2tb(case):
    m, n, nb, dtype = GE2TB[case]
    return js.ge2tb(_jm(_ge(SEED, m, n, dtype), nb))


@pytest.mark.parametrize("case", list(GE2TB))
def test_ge2tb_matches_jax(case):
    m, n, nb, dtype = GE2TB[case]
    A0 = _ge(SEED, m, n, dtype)
    got = ts.ge2tb(_tm(A0, nb))
    ref = _jax_ge2tb(case)
    tol = 50 * max(m, n) * _eps(dtype) * _n1(A0)
    band = got[0]
    assert isinstance(band, stt.TriangularBandMatrix) and band.kd == nb
    assert band.uplo == stt.Uplo.Upper
    for name, g, r in zip(("band", "UV", "UT", "VV", "VT"), got, ref):
        g = _np(g.T if name in ("UT", "VT") else g)
        r = np.asarray(r.T if name in ("UT", "VT") else r.to_global())
        assert g.shape == r.shape and g.dtype == r.dtype, name
        np.testing.assert_allclose(g, r, rtol=0, atol=tol, err_msg=name)
    B = _np(band)
    i, j = np.meshgrid(range(m), range(n), indexing="ij")
    assert np.abs(B[(i > j) | (j - i > nb)]).max(initial=0) == 0
    np.testing.assert_allclose(np.linalg.svd(B, compute_uv=False),
                               np.linalg.svd(A0, compute_uv=False), rtol=0, atol=tol)


@pytest.mark.parametrize("case", ["square", "tall_ragged_c128"])
def test_ge2tb_back_transforms_reproduce_a(case):
    """Q_U B Q_V^H = A through the port's own reflectors."""
    m, n, nb, dtype = GE2TB[case]
    A0 = _ge(SEED, m, n, dtype)
    A = _tm(A0, nb)
    band, UV, UT, VV, VT = ts.ge2tb(A)
    QB = ts.unmbr_ge2tb_left(UV, UT, band.to_global(), A)
    got = _np(ts.unmbr_ge2tb_right(VV, VT, QB.to_global(), A))
    np.testing.assert_allclose(got, A0, rtol=0, atol=50 * max(m, n) * _eps(dtype) * _n1(A0))


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("case", ["square", "wide_ragged", "tall_ragged_c128"])
def test_unmbr_ge2tb_on_jax_factors(case, side):
    m, n, nb, dtype = GE2TB[case]
    jband, jUV, jUT, jVV, jVT = _jax_ge2tb(case)
    band, UV, UT, VV, VT = ge2tb_from_reference(
        np.asarray(jband.data), np.asarray(jUV.data), np.asarray(jUT.T), np.asarray(jVV.data),
        np.asarray(jVT.T), m=m, n=n, nb=nb, device="cpu")
    np.testing.assert_array_equal(_np(band), np.asarray(jband.to_global()))
    assert band.kd == nb and VV.m == VV.n == n
    rng = np.random.default_rng(2)
    shape = (m, 7) if side == "left" else (7, n)
    C0 = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        C0 = C0 + 1j * rng.standard_normal(shape)
    C0 = C0.astype(dtype)
    A_j, A_t = _jm(_ge(SEED, m, n, dtype), nb), _tm(_ge(SEED, m, n, dtype), nb)
    if side == "left":
        ref = js.unmbr_ge2tb_left(jUV, jUT, C0, A_j)
        got = ts.unmbr_ge2tb_left(UV, UT, torch.from_numpy(C0), A_t)
    else:
        ref = js.unmbr_ge2tb_right(jVV, jVT, C0, A_j)
        got = ts.unmbr_ge2tb_right(VV, VT, torch.from_numpy(C0), A_t)
    ref, got = np.asarray(ref.to_global()), _np(got)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=50 * max(m, n) * _eps(dtype) * _n1(C0))


@pytest.mark.parametrize("m,n,nb,p,q,dtype", [
    (40, 40, 8, 1, 1, np.float64), (50, 34, 16, 1, 1, np.complex128),
    (90, 70, 8, 2, 3, np.float64), (70, 45, 8, 3, 2, np.float32)])
def test_upper_band_diagonals_tiles_bitwise(m, n, nb, p, q, dtype):
    """The packed superdiagonals from the same tile array (any p x q
    storage order) are bitwise the JAX package's."""
    B = np.triu(np.tril(_ge(5, m, n, dtype), nb))
    jl = JLayout(m, n, nb, nb, p, q)
    T = np.array(j_tiles(B, jl))
    ref = np.asarray(jbg.upper_band_diagonals_tiles(T, jl, n))
    got = tbg.upper_band_diagonals_tiles(torch.from_numpy(T), TileLayout(m, n, nb, nb, p, q), n)
    assert got.shape == ref.shape == (nb + 1, n)
    np.testing.assert_array_equal(_np(got), ref)
    for t in range(nb + 1):
        np.testing.assert_array_equal(ref[t, :n - t], np.diagonal(B[:n, :n], t))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_jw_band_storage_bitwise(dtype):
    n, b = 30, 4
    Dg = _ge(7, b + 1, n, dtype)
    Dg[np.arange(n)[None, :] + np.arange(b + 1)[:, None] >= n] = 0
    W, bw, n2 = js._jw_band_storage(Dg, b, n)
    Wt, bwt, n2t = ts._jw_band_storage(torch.from_numpy(Dg), b, n)
    assert (bwt, n2t) == (bw, n2) == (2 * b + 1, 2 * n)
    np.testing.assert_array_equal(_np(Wt), np.asarray(W))


# ---------------------------------------------------------------------------
# svd
# ---------------------------------------------------------------------------

# (m, n, nb, dtype, jax_vectors): the JAX tests' shapes (the dense band
# route, svd_accurate on the gathered band, with the tall and wide
# pre-reductions) and the JW route at n = 80 (square, tall with and
# without the pre-reduction, wide), float32 and complex128 among them
SVD = {
    "48x48": (48, 48, 8, np.float64, True),
    "64x32_tall": (64, 32, 8, np.float64, True),
    "32x64_wide": (32, 64, 8, np.float64, True),
    "40x24": (40, 24, 8, np.float64, True),
    "ragged_50x50": (50, 50, 16, np.float64, True),
    "ragged_50x34": (50, 34, 16, np.float64, True),
    "ragged_34x50": (34, 50, 16, np.float64, True),
    "jw_80x80": (80, 80, 8, np.float64, True),
    "jw_96x80": (96, 80, 8, np.float64, False),
    "jw_200x80_tall": (200, 80, 8, np.float64, False),
    "jw_80x200_wide": (80, 200, 8, np.float64, False),
    "jw_80x80_f32": (80, 80, 8, np.float32, False),
    "jw_80x80_c128": (80, 80, 8, np.complex128, False),
}


def _jw(m, n, nb):
    k = min(m, n)
    tall = max(m, n) >= 2 * k  # the pre-reduction leaves a k x k core
    mm, nn = (k, k) if tall else (m, n)
    return nn <= mm and nn > 4 * (2 * nb + 1)


@functools.lru_cache(maxsize=None)
def _jax_svd(case):
    m, n, nb, dtype, vectors = SVD[case]
    s, U, Vh = js.svd(_jm(_ge(SEED, m, n, dtype), nb), vectors=vectors)
    if not vectors:
        return np.asarray(s), None, None
    return np.asarray(s), np.asarray(U.to_global()), np.asarray(Vh.to_global())


def _separated(s, a1):
    gaps = np.abs(np.diff(s))
    gap = np.minimum(np.concatenate([[np.inf], gaps]), np.concatenate([gaps, [np.inf]]))
    return gap > 1e-3 * a1


def _phased_identity(X, Y, sep, dtype):
    P = np.abs(X.conj().T @ Y)[np.ix_(sep, sep)]
    tol = 1e-3 if np.dtype(dtype) == np.float32 else 1e-8
    np.testing.assert_allclose(P, np.eye(int(sep.sum())), rtol=0, atol=tol)


def _orth(X, k, eps):
    return _n1(X.conj().T @ X - np.eye(k)) / (k * eps)


def _svd_checks(A0, s, U, Vh, dtype):
    """Values against numpy; reconstruction; returns numpy's (s, U, Vh)
    and the orthogonality of U and V."""
    m, n = A0.shape
    k, mx = min(m, n), max(m, n)
    eps, a1 = _eps(dtype), _n1(A0)
    Ur, sr, Vhr = np.linalg.svd(A0.astype(_wide(dtype)), full_matrices=False)
    assert np.abs(s - sr).max() <= 10 * mx * eps * a1, np.abs(s - sr).max() / (mx * eps * a1)
    if U is None:
        return sr, Ur, Vhr, None, None
    assert U.shape == (m, k) and Vh.shape == (k, n) and U.dtype == Vh.dtype == dtype
    A64, U64, Vh64 = A0.astype(_wide(dtype)), U.astype(_wide(dtype)), Vh.astype(_wide(dtype))
    rec = _n1(A64 - (U64 * s[None, :]) @ Vh64) / (a1 * mx * eps)
    assert rec <= 100, rec
    return sr, Ur, Vhr, _orth(U64, k, eps), _orth(Vh64.conj().T, k, eps)


@pytest.mark.parametrize("case", list(SVD))
def test_svd_matches_jax(case):
    m, n, nb, dtype, jax_vectors = SVD[case]
    A0 = _ge(SEED, m, n, dtype)
    k = min(m, n)
    jw = _jw(m, n, nb)
    expect = ({"device": 1} if dtype != np.float64 else {"host": 1}) if jw else {}
    with metrics.deltas() as d:
        s, U, Vh = stt.svd(_tm(A0, nb), vectors=True)
        assert _route(d) == expect, _route(d)
        assert not d.get("heev.hb2st.host") and not d.get("heev.hb2st.device")
    s, U, Vh = _np(s), _np(U), _np(Vh)
    assert s.shape == (k,) and s.dtype == np.finfo(dtype).dtype
    sr, Ur, _, ou, ov = _svd_checks(A0, s, U, Vh, dtype)
    sj, Uj, Vhj = _jax_svd(case)
    a1 = _n1(A0)
    np.testing.assert_allclose(s, sj, rtol=0, atol=10 * max(m, n) * _eps(dtype) * a1)
    sep = _separated(sr, a1)
    if jax_vectors:
        assert Uj.shape == U.shape and Vhj.shape == Vh.shape
        _phased_identity(U, Uj, sep, dtype)
        _phased_identity(Vh.conj().T, Vhj.conj().T, sep, dtype)
    _phased_identity(U, Ur, sep, dtype)
    assert ou <= 100 and ov <= 100, (ou, ov)
    # values only: the same route, no vectors
    with metrics.deltas() as d:
        sv, none_u, none_v = stt.svd(_tm(A0, nb))
        assert _route(d) == expect
    assert none_u is None and none_v is None
    _svd_checks(A0, _np(sv), None, None, dtype)
    np.testing.assert_allclose(_np(sv), sj, rtol=0, atol=10 * max(m, n) * _eps(dtype) * a1)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128])
def test_svd_jw_gates_at_256(dtype):
    """The card's gates on the JW route at n = 256 with tiles of 16,
    whose JW tridiagonal (2n = 512) needs no padding in stedc, as phase
    16's (2n = 4096, 2048): reconstruction and orthogonality <= 100,
    values against numpy."""
    m = n = 256
    A0 = _ge(SEED, m, n, dtype)
    with metrics.deltas() as d:
        s, U, Vh = stt.svd(_tm(A0, 16), vectors=True)
        assert _route(d) == ({"host": 1} if dtype == np.float64 else {"device": 1})
    _, _, _, ou, ov = _svd_checks(A0, _np(s), _np(U), _np(Vh), dtype)
    assert ou <= 100 and ov <= 100, (ou, ov)


def test_svd_device_route_without_native(monkeypatch):
    """Without the native library a real float64 SVD takes the device
    wavefront, and the counter says so."""
    monkeypatch.setattr(te.native, "hb2st_available", lambda: False)
    A0 = _ge(SEED, 80, 80)
    with metrics.deltas() as d:
        s, U, Vh = stt.svd(_tm(A0, 8), vectors=True)
        assert _route(d) == {"device": 1}
    _svd_checks(A0, _np(s), _np(U), _np(Vh), np.float64)
    sj, _, _ = _jax_svd("jw_80x80")
    np.testing.assert_allclose(_np(s), sj, rtol=0, atol=10 * 80 * _eps(np.float64) * _n1(A0))


def test_svd_stages_are_timed():
    A0 = _ge(SEED, 80, 80)
    metrics.reset()
    stt.svd(_tm(A0, 8), vectors=True)
    tm = metrics.timers()
    for name in ("svd", "ge2tb", "spmd.upper_band_diagonals_tiles", "svd.hb2st", "steqr",
                 "stedc", "svd.unmtr_hb2st", "unmbr_ge2tb_left", "unmbr_ge2tb_right"):
        assert name in tm, name
    assert "svd.eigvals" not in tm
    stt.svd(_tm(A0, 8))
    assert "svd.eigvals" in metrics.timers()


def test_svd_guards_float32_precision(monkeypatch):
    """svd's float32 path goes through the TF32 guard before its first
    product (ge2tb's panels are plain ``@``; every later product calls
    ``hdot``, which raises on a CUDA tensor under TF32)."""
    seen = []
    real = ts.check_f32_precision

    def spy(*t):
        seen.append(tuple(x.dtype for x in t))
        return real(*t)

    monkeypatch.setattr(ts, "check_f32_precision", spy)
    stt.svd(_tm(_ge(SEED, 40, 40, np.float32), 8))
    assert seen and all(s == (torch.float32,) for s in seen), seen

    def raising(*t):
        raise RuntimeError("tf32")

    monkeypatch.setattr(ts, "check_f32_precision", raising)
    for fn in (stt.svd, stt.ge2tb):
        with pytest.raises(RuntimeError, match="tf32"):
            fn(_tm(_ge(SEED, 40, 40, np.float32), 8))


# ---------------------------------------------------------------------------
# tb2bd, bdsqr, the verbs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,nb", [(80, 80, 8), (48, 48, 16)])  # JW, svd_accurate
def test_tb2bd_on_the_band(m, n, nb):
    A0 = _ge(SEED, m, n)
    band = ts.ge2tb(_tm(A0, nb))[0]
    d, e, U, Vh = stt.tb2bd(band)
    B = _np(band)
    assert e.shape == (n - 1,) and not e.any() and e.dtype == torch.float64
    sr = np.linalg.svd(B, compute_uv=False)
    tol = 10 * n * _eps(np.float64) * _n1(B)
    np.testing.assert_allclose(_np(d), sr, rtol=0, atol=tol)
    U, Vh = _np(U), _np(Vh)
    assert _n1(B - (U * _np(d)) @ Vh) / (_n1(B) * n * _eps(np.float64)) <= 100
    if not _jw(m, n, nb):
        jd, je_, _, _ = js.tb2bd(js.ge2tb(_jm(A0, nb))[0])
        np.testing.assert_allclose(_np(d), np.asarray(jd), rtol=0, atol=tol)
        assert np.asarray(je_).shape == e.shape


@pytest.mark.parametrize("n", [1, 2, 16, 40])
def test_bdsqr_matches_jax(n):
    rng = np.random.default_rng(SEED)
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    B = np.diag(d) + np.diag(e, 1)
    sr = np.linalg.svd(B, compute_uv=False)
    s, none_u, none_v = stt.bdsqr(torch.from_numpy(d), torch.from_numpy(e))
    assert none_u is None and none_v is None
    tol = 10 * n * _eps(np.float64) * max(sr[0], 1)
    np.testing.assert_allclose(_np(s), sr, rtol=0, atol=tol)
    sj, _, _ = js.bdsqr(d, e)
    np.testing.assert_allclose(_np(s), np.asarray(sj), rtol=0, atol=tol)
    s, U, Vh = stt.bdsqr(d, e, vectors=True)  # numpy operands as in the JAX package
    s, U, Vh = _np(s), _np(U), _np(Vh)
    np.testing.assert_allclose(s, sr, rtol=0, atol=tol)
    assert U.shape == Vh.shape == (n, n)
    np.testing.assert_allclose((U * s) @ Vh, B, rtol=0, atol=100 * n * _eps(np.float64) * _n1(B))
    np.testing.assert_allclose(U.T @ U, np.eye(n), rtol=0, atol=1e-10)


def test_svd_verbs():
    A0 = _ge(SEED, 80, 80)
    s, U, Vh = tsimp.svd(_tm(A0, 8))
    s0, U0, Vh0 = stt.svd(_tm(A0, 8), vectors=True)
    for got, ref in ((s, s0), (U, U0), (Vh, Vh0)):
        np.testing.assert_array_equal(_np(got), _np(ref))
    np.testing.assert_array_equal(_np(tsimp.svd_vals(_tm(A0, 8))), _np(stt.svd(_tm(A0, 8))[0]))
