"""Port parity: the matrix generator of slate_tpu_torch (``matgen``)
against the JAX package's on the CPU.

Tolerances: bitwise where the JAX package's arithmetic is integer or a
correctly rounded IEEE operation on the same operands (the special
entries' divisions, the uniform and binary Philox draws, the sigma
tables); 4 ulps where a transcendental function of the library enters
(``cos``/``sin`` of chebspec and orthog, the Box-Muller draws of randn,
the ``exp`` of the logrand spectrum);
``50 n eps max|ref|`` for the spectrum kinds, whose orthogonal factors
come from a QR of the two packages' own libraries; a row-sum diagonal
(``dominant``) within ``n eps`` of its sum."""

import importlib

import numpy as np
import pytest
import torch

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu.exceptions import SlateError as JSlateError
from slate_tpu_torch.exceptions import SlateError

J = importlib.import_module("slate_tpu.matgen.generate")
T = importlib.import_module("slate_tpu_torch.matgen.generate")

torch.set_num_threads(1)

CPU = stt.ProcessGrid.single("cpu")
EPS64 = float(np.finfo(np.float64).eps)

SPECIAL = ("zeros ones identity ij jordan jordanT chebspec circul fiedler gfpp kms "
           "orthog riemann ris zielkeNS minij hilb frank lehmer lotkin redheff triw "
           "tridiag toeppen pei parter moler cauchy chow clement gcdmat").split()
TRANSCENDENTAL = {"chebspec", "orthog"}
DISTS = ("rand rands randn logrand arith geo cluster0 cluster1 rarith rgeo rcluster0 "
         "rcluster1").split()
LIBM_DISTS = {"randn", "logrand"}  # Box-Muller's log/cos, logrand's exp


def _ulps(a, b):
    """Largest distance of b from a in units of a's last place."""
    a, b = np.asarray(a), np.asarray(b)
    return float((np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.finfo(a.dtype).tiny)))
                 .max(initial=0.0))


def _within_ulps(got, ref, k=4):
    ref = np.asarray(ref)
    if np.iscomplexobj(ref):
        _within_ulps(got.real, ref.real, k)
        _within_ulps(got.imag, ref.imag, k)
        return
    assert _ulps(ref, got) <= k


def _tol(n, ref):
    return 50 * n * EPS64 * max(float(np.abs(ref).max()), 1.0)


# ---------------------------------------------------------------------------
# the kind grammar
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rand", "svd_geo_dominant", "poev-arith-small",
                                  "heev_rgeo_large_zerocol3", "diag_cluster1_ufl",
                                  "geev_specified_ofl", "randn_zerocol0.5", "hilb",
                                  "svd", "geevx_rcluster0_dominant"])
def test_parse_kind_matches_jax(kind):
    assert T.parse_kind(kind) == J.parse_kind(kind)


@pytest.mark.parametrize("kind", ["noSuchKind_x", "rand_geo", "hilb_bogus", "", "_rand",
                                  "svd_geo_tiny"])
def test_parse_kind_rejects_like_jax(kind):
    with pytest.raises(JSlateError):
        J.parse_kind(kind)
    with pytest.raises(SlateError):
        T.parse_kind(kind)


def test_unknown_base_and_bad_zerocol_rejected():
    with pytest.raises(SlateError):
        T.generate_2d("noSuchKind", 4, 4, device="cpu")
    with pytest.raises(SlateError):
        T.generate_2d("rand_zerocol9", 4, 4, device="cpu")
    with pytest.raises(SlateError):
        T._sigma("specified", 4, 10.0, 1.0, 1, torch.float64, None, "cpu")


# ---------------------------------------------------------------------------
# special entries and sigma
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7, 5), (6, 6)], ids=["7x5", "6x6"])
@pytest.mark.parametrize("base", SPECIAL)
def test_special_entry_matches_jax(base, shape):
    m, n = shape
    ref = np.asarray(J._special_entry(base, m, n, np.float64))
    got = T._special_entry(base, m, n, torch.float64, "cpu").numpy()
    assert got.dtype == np.float64 and got.shape == (m, n)
    if base in TRANSCENDENTAL:
        _within_ulps(got, ref)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dist", DISTS)
def test_sigma_matches_jax(dist):
    ref = np.asarray(J._sigma(dist, 9, 1e4, 2.0, 5, np.float64))
    got = T._sigma(dist, 9, 1e4, 2.0, 5, torch.float64, device="cpu").numpy()
    if dist in LIBM_DISTS:
        _within_ulps(got, ref)
    else:
        np.testing.assert_array_equal(got, ref)
    spec = [3.0, 2.0, 0.5]
    np.testing.assert_array_equal(
        T._sigma("specified", 3, 1.0, 1.0, 0, torch.float32, spec, "cpu").numpy(),
        np.asarray(J._sigma("specified", 3, 1.0, 1.0, 0, np.float32, spec)))


# ---------------------------------------------------------------------------
# generate_2d
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128])
@pytest.mark.parametrize("kind", ["rand", "rands", "randb", "randr", "randn", "rand_small"])
def test_generate_2d_rand_kinds_match_jax(kind, dtype):
    ref, _ = J.generate_2d(kind, 13, 9, dtype, seed=11)
    got, sig = T.generate_2d(kind, 13, 9, dtype, seed=11, device="cpu")
    ref, got = np.asarray(ref), got.numpy()
    assert sig is None and got.dtype == ref.dtype
    if kind == "randn":
        _within_ulps(got, ref)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind,m,n,dtype", [
    ("svd_geo", 24, 24, np.float64), ("svd_geo", 30, 18, np.float64),
    ("poev_logrand", 20, 20, np.float64), ("heev_arith", 20, 20, np.float64),
    ("heev_geo", 16, 16, np.complex128), ("geev_arith", 16, 16, np.float64),
    ("diag_arith", 10, 10, np.float64), ("svd_rgeo", 12, 12, np.float32),
    ("poev_cluster0", 12, 12, np.complex128),
])
def test_generate_2d_spectrum_kinds_match_jax(kind, m, n, dtype):
    ref, sref = J.generate_2d(kind, m, n, dtype, seed=4, cond=50.0)
    got, sig = T.generate_2d(kind, m, n, dtype, seed=4, cond=50.0, device="cpu")
    ref, got = np.asarray(ref), got.numpy()
    assert got.dtype == ref.dtype and got.shape == (m, n)
    if kind.split("_")[1] in LIBM_DISTS:
        _within_ulps(sig.numpy(), np.asarray(sref))
    else:
        np.testing.assert_array_equal(sig.numpy(), np.asarray(sref))
    eps = np.finfo(ref.dtype).eps
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=50 * max(m, n) * eps * float(np.abs(ref).max()))


@pytest.mark.parametrize("kind", ["rand_dominant", "rands_dominant", "hilb_dominant",
                                  "rand_zerocol3", "rand_zerocol0.5", "hilb_zerocol0"])
def test_generate_2d_modifiers_match_jax(kind):
    ref = np.asarray(J.generate_2d(kind, 8, 8, seed=2)[0])
    got = T.generate_2d(kind, 8, 8, seed=2, device="cpu")[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=8 * EPS64, atol=0)
    off = ~np.eye(8, dtype=bool)
    np.testing.assert_array_equal(got[off], ref[off])


# the JAX package's own property checks (tests/test_matgen.py), on the port
def _g(kind, m=16, n=16, **kw):
    A, S = T.generate_2d(kind, m, n, device="cpu", **kw)
    return A.numpy(), None if S is None else S.numpy()


def _prop_special():
    assert np.array_equal(_g("identity")[0], np.eye(16))
    A, _ = _g("jordan", 4, 4)
    assert np.array_equal(A, np.eye(4) + np.diag(np.ones(3), 1))
    assert np.array_equal(_g("jordanT", 4, 4)[0], A.T)
    i, j = np.meshgrid(range(5), range(5), indexing="ij")
    assert np.array_equal(_g("minij", 5, 5)[0], np.minimum(i, j) + 1)
    np.testing.assert_allclose(_g("lehmer", 5, 5)[0],
                               (np.minimum(i, j) + 1) / (np.maximum(i, j) + 1))
    C, _ = _g("clement", 4, 4)
    assert C[1, 0] == 3 and C[0, 1] == 1 and C[2, 2] == 0
    assert _g("gcdmat", 6, 6)[0][3, 5] == np.gcd(4, 6)
    Ci, _ = _g("circul", 4, 4)
    assert Ci[0, 0] == 1 and Ci[3, 0] == 2  # wraps


def _prop_orthog():
    Q, _ = _g("orthog", 12, 12)
    np.testing.assert_allclose(Q @ Q.T, np.eye(12), atol=1e-12)


def _prop_rand():
    assert np.array_equal(_g("rand", seed=7)[0], _g("rand", seed=7)[0])
    assert not np.array_equal(_g("rand", seed=7)[0], _g("rand", seed=8)[0])
    A, _ = _g("rands", 64, 64)
    assert A.min() < 0 < A.max() and np.abs(A).max() <= 1
    assert set(np.unique(_g("randb", 32, 32)[0])) <= {0.0, 1.0}
    A, _ = _g("rand_dominant")
    for r in range(16):
        assert abs(A[r, r]) >= np.abs(A[r]).sum() - abs(A[r, r]) - 1e-10
    assert np.all(_g("rand_zerocol0.5", 8, 8)[0][:, 3] == 0)


def _prop_svd():
    A, S = _g("svd_geo", 24, 24, cond=100.0)
    sv = np.linalg.svd(A, compute_uv=False)
    np.testing.assert_allclose(sorted(sv), sorted(np.abs(S)), rtol=1e-10)
    A, S = _g("svd_geo", 30, 18, cond=10.0)
    assert A.shape == (30, 18) and S.shape == (18,)


def _prop_heev():
    for dtype in (np.float64, np.complex128):
        A, S = _g("heev_arith", 20, 20, cond=50.0, dtype=dtype)
        np.testing.assert_allclose(A, A.T.conj(), atol=1e-12)
        np.testing.assert_allclose(sorted(np.linalg.eigvalsh(A)), sorted(S), atol=1e-10)
    A, S = _g("poev_logrand", 20, 20, cond=10.0)
    assert np.linalg.eigvalsh(A).min() > 0 and (S > 0).all()


def _prop_geev_diag():
    A, S = _g("geev_arith", 16, 16, cond=10.0)
    np.testing.assert_allclose(sorted(np.linalg.eigvals(A).real), sorted(S), atol=1e-8)
    A, S = _g("diag_arith", 10, 10, cond=4.0)
    np.testing.assert_allclose(np.diag(A), S)
    assert np.abs(A - np.diag(np.diag(A))).max() == 0


@pytest.mark.parametrize("check", [_prop_special, _prop_orthog, _prop_rand, _prop_svd,
                                   _prop_heev, _prop_geev_diag],
                         ids=lambda f: f.__name__[6:])
def test_generate_2d_properties(check):
    check()


# ---------------------------------------------------------------------------
# generate_matrix / generate_tiles / generate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["rand", "rands", "randb", "randr", "randn", "rand_large"])
def test_generate_matrix_bitwise_across_tilings_and_matches_jax(kind, dtype):
    m, n = 50, 37
    A16, _ = stt.generate_matrix(kind, stt.Matrix.zeros(m, n, 16, dtype=dtype, grid=CPU), seed=7)
    A8, _ = stt.generate_matrix(kind, stt.Matrix.zeros(m, n, 8, dtype=dtype, grid=CPU), seed=7)
    got = A16.to_global().numpy()
    np.testing.assert_array_equal(got, A8.to_global().numpy())
    # the padding stays zero
    pad = ~A16.layout.element_mask().numpy()
    assert (A16.data.numpy()[pad] == 0).all()
    jdt = np.float64 if dtype == torch.float64 else np.float32
    if kind == "randn":
        # the JAX package's device path draws its normals with XLA's
        # log/cos, up to 30 ulps of max|A| from its host path (numpy's
        # libm, ``generate_2d``); the port holds to the host path
        _within_ulps(got, np.asarray(J.generate_2d(kind, m, n, jdt, seed=7)[0]))
        return
    Aj, _ = J.generate_matrix(kind, st.Matrix.from_global(np.zeros((m, n), jdt), 16), seed=7)
    np.testing.assert_array_equal(got, np.asarray(Aj.to_global()))


def test_generate_tiles_strips_change_no_bit(monkeypatch):
    """A pass of a few element rows gives the bits of one whole pass."""
    lay = stt.Matrix.zeros(45, 29, 8, dtype=torch.float64, grid=CPU).layout
    whole = T.generate_tiles("randn", lay, torch.float64, 3, "cpu")
    monkeypatch.setattr(T, "_TILE_PASS_ELEMENTS", 3 * lay.Q * lay.nb)
    np.testing.assert_array_equal(T.generate_tiles("randn", lay, torch.float64, 3, "cpu").numpy(),
                                  whole.numpy())
    assert T.generate_tiles("hilb", lay, torch.float64) is None
    assert T.generate_tiles("rand_dominant", lay, torch.float64) is None


@pytest.mark.parametrize("kind", ["hilb", "svd_geo", "rand_zerocol2"])
def test_generate_matrix_structured_kinds(kind):
    A, S = stt.generate_matrix(kind, stt.Matrix.zeros(20, 20, 8, dtype=torch.float64, grid=CPU),
                               seed=5, cond=30.0)
    G, S2 = T.generate_2d(kind, 20, 20, torch.float64, seed=5, cond=30.0, device="cpu")
    np.testing.assert_array_equal(A.to_global().numpy(), G.numpy())
    assert (S is None) == (S2 is None)
    Aj, _ = J.generate_matrix(kind, st.Matrix.from_global(np.zeros((20, 20)), 8), seed=5,
                              cond=30.0)
    ref = np.asarray(Aj.to_global())
    np.testing.assert_allclose(A.to_global().numpy(), ref, rtol=0, atol=_tol(20, ref))


def test_generate_convenience_matches_generate_2d():
    M = T.generate("rands", 12, 10, 4, 5, grid=CPU, seed=9)
    assert (M.mb, M.nb) == (4, 5) and M.device.type == "cpu"
    np.testing.assert_array_equal(M.to_global().numpy(),
                                  T.generate_2d("rands", 12, 10, seed=9, device="cpu")[0].numpy())


# ---------------------------------------------------------------------------
# cond_matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spd", [False, True], ids=["svd", "spd"])
def test_cond_matrix_matches_jax(spd):
    got = T.cond_matrix(40, 1e5, spd=spd, device="cpu")
    ref = J.cond_matrix(40, 1e5, spd=spd)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(40, ref))


def test_cond_matrix_specified_condition():
    A = T.cond_matrix(48, 1e4, device="cpu")
    assert np.linalg.cond(A) == pytest.approx(1e4, rel=1e-6)
    # deterministic for a seed; different seed, different matrix
    assert np.array_equal(A, T.cond_matrix(48, 1e4, device="cpu"))
    assert not np.array_equal(A, T.cond_matrix(48, 1e4, seed=1, device="cpu"))


def test_cond_matrix_spd():
    S = T.cond_matrix(32, 1e6, spd=True, device="cpu")
    assert np.abs(S - S.T).max() < 1e-14
    w = np.linalg.eigvalsh(S)
    assert w.min() > 0
    assert w.max() / w.min() == pytest.approx(1e6, rel=1e-6)


def test_cond_matrix_rejects_bad_cond():
    with pytest.raises(SlateError):
        T.cond_matrix(8, 0.5, device="cpu")
