"""Port parity: the QR / least-squares drivers of slate_tpu_torch
(``drivers/qr.py``, the BLAS3 routines ``cholqr`` uses, and
``geqrf_from_reference``) against the JAX package, on the CPU.

The same numpy inputs (seeded) go through both packages.  Both packages
follow LAPACK's sign convention (beta = -sign(alpha) ||x||), so the
factors agree and not just up to sign.  Tolerance: R, V, T and the
drivers' outputs within ``1e-11 max|ref|`` in float64 (complex128 too;
1e-9 for CholQR, which squares the condition number); least-squares
solutions also within 1e-8 of numpy's ``lstsq``, as tests/test_qr.py
holds the JAX package."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu.drivers import qr as jqr
from slate_tpu_torch.drivers import qr as tqr
from slate_tpu_torch.ops.hopper import panel_kernels as pk

torch.set_num_threads(1)

CPU = stt.ProcessGrid.single("cpu")
RTOL = 1e-11


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(float(np.abs(ref).max()), 1.0))


def _rand(m, n, seed, complex_=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    if complex_:
        a = a + 1j * rng.standard_normal((m, n))
    return a


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


@pytest.fixture(autouse=True)
def _no_launches():
    pk.reset_launches()
    yield
    assert all(v == 0 for v in pk.LAUNCHES.values()), pk.LAUNCHES  # CPU: plain versions


# ---------------------------------------------------------------------------
# drivers/qr.py
# ---------------------------------------------------------------------------


def _pair(a, nb):
    return st.Matrix.from_global(a, nb), stt.Matrix.from_global(a, nb, grid=CPU)


@pytest.mark.parametrize("sched", ["auto", "flat", "recursive", "pallas"])
def test_geqrf_driver_every_route_matches_jax(sched):
    """``flat`` on (256, 128) in tiles of 32 is the native flat schedule,
    the others on (100, 70) in tiles of 16, which pads and splices;
    ``auto`` on the CPU is the library QR."""
    m, n, nb = (256, 128, 32) if sched == "flat" else (100, 70, 16)
    for a in (_rand(m, n, m + n),):
        o = {"schedule": sched, "block_size": 64}
        jA, tA = _pair(a, nb)
        jf, jT = jqr.geqrf(jA, o)
        tf, tT = tqr.geqrf(tA, o)
        _close(tf.to_global().numpy(), jf.to_global())
        _close(tT.T.numpy(), jT.T)


@pytest.fixture(scope="module")
def factors():
    """geqrf of one (72, 48) matrix in each package, real and complex."""
    out = {}
    for complex_ in (False, True):
        jA, tA = _pair(_rand(72, 48, 7, complex_), 16)
        out[complex_] = (*jqr.geqrf(jA), *tqr.geqrf(tA))
    return out


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("side,op", list(itertools.product(
    ["Left", "Right"], ["NoTrans", "Trans", "ConjTrans"])))
def test_unmqr_matches_jax(factors, side, op, complex_):
    c = _rand(72, 72, 8, complex_)
    jf, jT, tf, tT = factors[complex_]
    ref = jqr.unmqr(st.Side[side], st.Op[op], jf, jT, st.Matrix.from_global(c, 16))
    got = tqr.unmqr(stt.Side[side], stt.Op[op], tf, tT, stt.Matrix.from_global(c, 16, grid=CPU))
    _close(got.to_global().numpy(), ref.to_global())


@pytest.mark.parametrize("complex_", [False, True])
def test_ungqr_gelqf_unmlq_match_jax(complex_):
    a = _rand(70, 40, 9, complex_)
    jA, tA = _pair(a, 16)
    jf, jT = jqr.geqrf(jA)
    tf, tT = tqr.geqrf(tA)
    Q = tqr.ungqr(tf, tT).to_global().numpy()
    _close(Q, jqr.ungqr(jf, jT).to_global())
    np.testing.assert_allclose(Q.conj().T @ Q, np.eye(40), rtol=0, atol=1e-13)
    w = _rand(30, 56, 10, complex_)
    jW, tW = _pair(w, 8)
    jl, jlT = jqr.gelqf(jW)
    tl, tlT = tqr.gelqf(tW)
    _close(tl.to_global().numpy(), jl.to_global())
    _close(tlT.T.numpy(), jlT.T)
    eye = np.eye(56, dtype=w.dtype)
    for op in ("NoTrans", "ConjTrans"):
        ref = jqr.unmlq(st.Side.Left, st.Op[op], jl, jlT, st.Matrix.from_global(eye, 8))
        got = tqr.unmlq(stt.Side.Left, stt.Op[op], tl, tlT,
                        stt.Matrix.from_global(eye, 8, grid=CPU))
        _close(got.to_global().numpy(), ref.to_global())


def test_cholqr_matches_jax():
    a = _rand(80, 24, 11)
    jQ, jR, jinfo = jqr.cholqr(st.Matrix.from_global(a, 8))
    tQ, tR, tinfo = tqr.cholqr(stt.Matrix.from_global(a, 8, grid=CPU))
    assert int(tinfo) == int(jinfo) == 0
    assert tR.uplo == stt.Uplo.Upper
    _close(tQ.to_global().numpy(), jQ.to_global(), 1e-9)
    _close(np.triu(tR.to_global().numpy()), np.triu(np.asarray(jR.to_global())), 1e-9)


@pytest.mark.parametrize("case", ["qr", "cholqr", "under", "qr_complex", "under_complex",
                                  "qr_pallas"])
def test_gels_matches_jax_and_lstsq(case):
    complex_ = case.endswith("complex")
    m, n = (24, 48) if case.startswith("under") else (64, 32)
    a, b = _rand(m, n, 12, complex_), _rand(m, 4, 13, complex_)
    o = {"method_gels": "cholqr"} if case == "cholqr" else {}
    if case == "qr_pallas":
        o = {"schedule": "pallas", "block_size": 16}
    jX = jqr.gels(st.Matrix.from_global(a, 8), st.Matrix.from_global(b, 8), o)
    tX = tqr.gels(stt.Matrix.from_global(a, 8, grid=CPU), stt.Matrix.from_global(b, 8, grid=CPU),
                  o)
    x = tX.to_global().numpy()
    _close(x, jX.to_global(), 1e-9 if case == "cholqr" else RTOL)
    ref = np.linalg.lstsq(a, b, rcond=None)[0]
    np.testing.assert_allclose(x[:n], ref, rtol=0, atol=1e-8)



_VIEWS = {"trans": (stt.transpose, np.transpose),
          "conj_trans": (stt.conj_transpose, lambda a: a.conj().T)}


@pytest.mark.parametrize("view", ["trans", "conj_trans"])
@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("stored", [(50, 70), (70, 50)])  # op(A) tall, wide
def test_gels_of_op_view_matches_lstsq(stored, complex_, view):
    """SLATE's gels solves op(A): a transposed or conjugate-transposed
    view of a stored-wide or stored-tall A, against numpy's lstsq on the
    materialized op(A) (the JAX package raises here).  Least-squares
    residual ||op(A)^H (op(A) X - B)||_1 / (||A||_1 (||A||_1 ||X||_1 +
    ||B||_1) m eps) <= 3, as PERF.md section 2 states it."""
    fview, fnp = _VIEWS[view]
    a = _rand(*stored, 21, complex_)
    opa = fnp(a)
    m = opa.shape[0]
    b = _rand(m, 3, 22, complex_)
    x = tqr.gels(fview(stt.Matrix.from_global(a, 16, grid=CPU)),
                 stt.Matrix.from_global(b, 16, grid=CPU)).to_global().numpy()
    assert x.shape == (opa.shape[1], 3)
    np.testing.assert_allclose(x, np.linalg.lstsq(opa, b, rcond=None)[0], rtol=0, atol=1e-10)
    n1 = lambda M: np.abs(M).sum(0).max()  # noqa: E731
    r = n1(opa.conj().T @ (opa @ x - b)) / (
        n1(opa) * (n1(opa) * n1(x) + n1(b)) * m * np.finfo(np.float64).eps)
    assert r <= 3, r


@pytest.mark.parametrize("view", ["trans", "conj_trans"])
@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("routine", ["geqrf", "gelqf"])
def test_factor_of_op_view_matches_materialized(routine, complex_, view):
    """geqrf / gelqf of a view equal the same routine on the
    materialized op(A): the factored matrix (NoTrans, op(A)'s shape)
    and the T stack."""
    fview, fnp = _VIEWS[view]
    fn = getattr(tqr, routine)
    for stored in ((50, 70), (70, 50)):
        a = _rand(*stored, 23, complex_)
        fac, T = fn(fview(stt.Matrix.from_global(a, 16, grid=CPU)))
        ref, Tref = fn(stt.Matrix.from_global(np.ascontiguousarray(fnp(a)), 16, grid=CPU))
        assert fac.op == stt.Op.NoTrans and (fac.m, fac.n) == (stored[1], stored[0])
        _close(fac.to_global().numpy(), ref.to_global().numpy(), 1e-13)
        _close(T.T.numpy(), Tref.T.numpy(), 1e-13)

def _pack(fac_global, Tstack, m, n, nb):
    """The serve tier's gels pack: V/R in rows [0, m), panel k's T in rows
    [m + k nb, m + k nb + w), columns [0, w)."""
    kt = Tstack.shape[0]
    F = np.zeros((m + kt * nb, n), dtype=fac_global.dtype)
    F[:m] = fac_global
    for k in range(kt):
        w = min(nb, n - k * nb)
        F[m + k * nb:m + k * nb + w, :w] = Tstack[k][:w, :w]
    return F


@pytest.mark.parametrize("complex_", [False, True])
def test_jax_factor_solved_by_the_port(complex_):
    """geqrf_from_reference carries a JAX geqrf result across; the port's
    unmqr and gels_solve_from_global solve with it."""
    m, n, nb = 96, 64, 16
    a, b = _rand(m, n, 14, complex_), _rand(m, 3, 15, complex_)
    jf, jT = jqr.geqrf(st.Matrix.from_global(a, nb))
    lay = jf.layout
    tf, tT = stt.geqrf_from_reference(np.asarray(jf.data), np.asarray(jT.T), m=lay.m, n=lay.n,
                                      mb=lay.mb, nb=lay.nb, p=lay.p, q=lay.q, device="cpu")
    _close(tf.to_global().numpy(), jf.to_global(), 0)
    ref = jqr.unmqr(st.Side.Left, st.Op.ConjTrans, jf, jT, st.Matrix.from_global(b, nb))
    got = tqr.unmqr(stt.Side.Left, stt.Op.ConjTrans, tf, tT,
                    stt.Matrix.from_global(b, nb, grid=CPU))
    _close(got.to_global().numpy(), ref.to_global())
    F = _pack(np.asarray(jf.to_global()), np.asarray(jT.T), m, n, nb)
    ref = np.asarray(jqr.gels_solve_from_global(jnp.asarray(F), jnp.asarray(b), m, nb))
    got = tqr.gels_solve_from_global(_t(F), _t(b), m, nb).numpy()
    _close(got, ref)
    np.testing.assert_allclose(got, np.linalg.lstsq(a, b, rcond=None)[0], rtol=0, atol=1e-8)


def test_port_factor_packs_like_the_jax_one():
    """The port's own geqrf result packed the same way solves the same."""
    m, n, nb = 80, 48, 16
    a, b = _rand(m, n, 16), _rand(m, 2, 17)
    tf, tT = tqr.geqrf(stt.Matrix.from_global(a, nb, grid=CPU))
    F = _pack(tf.to_global().numpy(), tT.T.numpy(), m, n, nb)
    x = tqr.gels_solve_from_global(_t(F), _t(b), m, nb).numpy()
    np.testing.assert_allclose(x, np.linalg.lstsq(a, b, rcond=None)[0], rtol=0, atol=1e-10)


def test_gemm_herk_syrk_match_jax():
    a, b, c = _rand(40, 24, 18), _rand(24, 16, 19), _rand(40, 16, 20)
    ref = st.gemm(1.5, st.Matrix.from_global(a, 8), st.Matrix.from_global(b, 8), -0.5,
                  st.Matrix.from_global(c, 8))
    got = stt.gemm(1.5, stt.Matrix.from_global(a, 8, grid=CPU),
                   stt.Matrix.from_global(b, 8, grid=CPU), -0.5,
                   stt.Matrix.from_global(c, 8, grid=CPU))
    _close(got.to_global().numpy(), ref.to_global())
    h = _rand(40, 40, 21)
    for name, cls, uplo in (("herk", "HermitianMatrix", "Lower"),
                            ("syrk", "SymmetricMatrix", "Upper")):
        jC = getattr(st, cls).from_global(h, 8, uplo=st.Uplo[uplo])
        tC = getattr(stt, cls).from_global(h, 8, grid=CPU, uplo=stt.Uplo[uplo])
        ref = getattr(st, name)(2.0, st.Matrix.from_global(a, 8), 0.5, jC)
        got = getattr(stt, name)(2.0, stt.Matrix.from_global(a, 8, grid=CPU), 0.5, tC)
        _close(got.full_global().numpy(), ref.full_global())
    # the transposed view cholqr uses: A^H A
    jH = st.HermitianMatrix.from_global(np.zeros((24, 24)), 8, uplo=st.Uplo.Upper)
    tH = stt.HermitianMatrix.from_global(np.zeros((24, 24)), 8, grid=CPU, uplo=stt.Uplo.Upper)
    ref = st.herk(1.0, st.conj_transpose(st.Matrix.from_global(a, 8)), 0.0, jH)
    got = stt.herk(1.0, stt.conj_transpose(stt.Matrix.from_global(a, 8, grid=CPU)), 0.0, tH)
    _close(got.full_global().numpy(), ref.full_global())
