"""Port parity: the mesh factorizations (``parallel/spmd_chol.py``,
``spmd_lu.py``, ``spmd_qr.py``) through ``potrf``, ``posv``, ``getrf``,
``gesv``, ``getri``, ``geqrf``, ``ungqr`` and ``gels``, on gloo ranks
against the JAX package's 2 x 2 and 4 x 2 virtual meshes and numpy.

The mesh cases of ``tests/test_chol.py`` (4), ``tests/test_lu.py`` (5,
CALU included) and ``tests/test_qr.py`` (3), with their parameters,
plus an Upper potrf, a matrix that is not positive definite, a complex
LU on the 4 x 2 mesh and the inverse.  The same seeded numpy operands go
to the JAX package and to a pool of 8 gloo ranks (``torch_mesh_pool``).
Tolerances: perm bitwise equal to the JAX package's (its partial-pivot
panel is LAPACK's on the CPU, the port's the ``panel_lu`` plain version:
the same pivots on operands without ties, which these are; the CALU
panels are op for op the same); factors within 50 n eps ||A||_1 of the
JAX package's, elementwise; the reference tester's factor, solve and
orthogonality residuals within 3 eps (``slate_tpu.testing.checks``);
no gather recorded."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.drivers import chol as jchol
from slate_tpu.drivers import lu as jlu
from slate_tpu.drivers import qr as jqr
from slate_tpu.testing import checks
from slate_tpu_torch.ops import lu_kernels as tlk
from torch_mesh_pool import MeshPool

torch.set_num_threads(1)

G22, G42 = (2, 2, "Col", 4), (4, 2, "Col", 8)
CALU = {"MethodLU": "CALU"}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = MeshPool(8, tmp_path_factory.mktemp("mesh"))
    yield p
    p.close()


def _spec(kind, a, mb, **kw):
    return (kind, a, mb, None, kw)


def _jmat(kind, a, mb, grid, **kw):
    kw = {k: getattr(st, k.capitalize())[v] for k, v in kw.items()}
    return getattr(st, kind).from_global(jnp.asarray(a), mb, grid=grid, **kw)


def _run(pool, grid, routine, args, **kw):
    """Rank 0's answer (every rank of the grid gathers the same)."""
    on = [r for r in pool.run("driver", grid=grid, routine=routine, args=args, **kw)
          if r is not None]
    assert all(r["fallbacks"] == on[0]["fallbacks"] for r in on)
    return on[0]


def _then(pool, grid, A0, nb, factor, then):
    """``then`` of ``factor``'s output on the mesh, gathered (rank 0's;
    every rank's is the same)."""
    on = [r for r in pool.run("factor_then", grid=grid, spec=_spec("Matrix", A0, nb),
                              factor=factor, then=then) if r is not None]
    for r in on[1:]:
        np.testing.assert_array_equal(r["global"], on[0]["global"])
    return on[0]["global"]


def _ok(err, dtype, factor=3.0):
    assert checks.passed(err, dtype, factor), err / checks.eps_of(dtype)


def _near(got, jax_out, A0):
    """Within 50 n eps ||A||_1 of the JAX package's, elementwise."""
    J = np.asarray(jax_out)
    tol = 50 * A0.shape[0] * checks.eps_of(A0.dtype) * np.abs(A0).sum(0).max()
    assert np.abs(got - J).max() <= tol, (np.abs(got - J).max(), tol)


def _spd(rng, n, dtype=np.float64):
    A = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        A = A + 1j * rng.standard_normal((n, n))
    return (A @ A.conj().T + n * np.eye(n)).astype(dtype)


def _mk(rng, m, n, dtype=np.float64):
    A = rng.standard_normal((m, n))
    if np.dtype(dtype).kind == "c":
        A = A + 1j * rng.standard_normal((m, n))
    return A.astype(dtype)


# -- Cholesky (tests/test_chol.py) ------------------------------------------


def _potrf(pool, jgrid, grid, A0, nb, uplo="Lower"):
    JL, jinfo = jchol.potrf(_jmat("HermitianMatrix", A0, nb, jgrid, uplo=uplo))
    R = _run(pool, grid, "chol.potrf", [_spec("HermitianMatrix", A0, nb, uplo=uplo)])
    L, info = R["out"]
    assert int(info) == int(jinfo) == 0
    return L, np.asarray(JL.to_global()), R["fallbacks"]


@pytest.mark.parametrize("n,nb", [(64, 16), (96, 16), (72, 8), (90, 16), (53, 8)])
def test_potrf_distributed(pool, rng, grid22, n, nb):
    A0 = _spd(rng, n)
    L, JL, fb = _potrf(pool, grid22, G22, A0, nb)
    Lg = np.tril(L["global"])
    _ok(checks.factor_residual(A0, Lg), np.float64)
    _near(Lg, np.tril(JL), A0)
    assert fb == {} and L["uplo"] == "Lower"


def test_potrf_distributed_complex_4x2(pool, rng, grid42):
    n, nb = 64, 8
    A0 = _spd(rng, n, np.complex128)
    L, JL, fb = _potrf(pool, grid42, G42, A0, nb)
    Lg = np.tril(L["global"])
    _ok(checks.factor_residual(A0, Lg), np.complex128)
    _near(Lg, np.tril(JL), A0)
    assert fb == {}


def test_potrf_spmd_matches_global(pool, rng):
    """The mesh algorithm agrees with the library Cholesky."""
    n, nb = 80, 16
    A0 = _spd(rng, n)
    R = _run(pool, G22, "chol.potrf", [_spec("HermitianMatrix", A0, nb, uplo="Lower")])
    np.testing.assert_allclose(np.tril(R["out"][0]["global"]), np.linalg.cholesky(A0),
                               atol=1e-9)


def test_potrf_upper_distributed_mirrors(pool, rng, grid22):
    """An Upper A is mirrored to the lower triangle first (recorded
    ``potrf.mirror``, as in the JAX package) and factors as U^H U."""
    n, nb = 64, 16
    A0 = _spd(rng, n)
    U, JU, fb = _potrf(pool, grid22, G22, A0, nb, uplo="Upper")
    Ug = np.triu(U["global"])
    _ok(checks.factor_residual(A0, Ug.conj().T), np.float64)
    _near(Ug, np.triu(JU), A0)
    assert fb == {"potrf.mirror": 1} and U["uplo"] == "Upper"


def test_potrf_not_spd_info_on_every_rank(pool):
    """A tile that is not positive definite gives info > 0, the same on
    every rank (the maximum over the ranks)."""
    n, nb = 48, 16
    A0 = np.eye(n)
    A0[40, 40] = -1.0  # a tile only the ranks of process row 0 hold
    J = jchol.potrf(st.HermitianMatrix.from_global(jnp.asarray(A0), nb))[1]
    got = [r for r in pool.run("driver", grid=G22, routine="chol.potrf",
                               args=[_spec("HermitianMatrix", A0, nb, uplo="Lower")])
           if r is not None]
    assert [int(r["out"][1]) for r in got] == [int(J)] * 4 == [1] * 4


def test_posv_distributed(pool, rng):
    """The solve's parity with the JAX package is
    tests/test_torch_spmd_trsm.py's; here the residual."""
    n, nrhs = 96, 16
    A0, B0 = _spd(rng, n), rng.standard_normal((n, nrhs))
    R = _run(pool, G22, "chol.posv", [_spec("HermitianMatrix", A0, 16, uplo="Lower"),
                                      _spec("Matrix", B0, 16)])
    X, _, info = R["out"]
    assert int(info) == 0 and R["fallbacks"] == {}
    _ok(checks.solve_residual(A0, X["global"], B0), np.float64)
    np.testing.assert_allclose(X["global"], np.linalg.solve(A0, B0), atol=1e-12)


# -- LU (tests/test_lu.py) ---------------------------------------------------


def _getrf(pool, jgrid, grid, A0, nb, opts=None):
    jopts = {st.Option.MethodLU: st.MethodLU.CALU} if opts else None
    JLU, jpiv, jinfo = jlu.getrf(_jmat("Matrix", A0, nb, jgrid), jopts)
    R = _run(pool, grid, "lu.getrf", [_spec("Matrix", A0, nb)], opts=opts)
    LU, piv, info = R["out"]
    assert int(info) == int(jinfo) == 0 and R["fallbacks"] == {}
    np.testing.assert_array_equal(piv["perm"], np.asarray(jpiv.perm))
    _near(LU["global"], JLU.to_global(), A0)
    return LU["global"], piv["perm"]


def _lu_residual(A0, G, perm):
    n = A0.shape[0]
    L = np.tril(G, -1) + np.eye(n)
    return checks.factor_residual(A0[perm[:n]], L, np.triu(G))


@pytest.mark.parametrize("n,nb", [(64, 16), (96, 16), (48, 8)])
def test_getrf_distributed(pool, rng, grid22, n, nb):
    A0 = _mk(rng, n, n)
    G, perm = _getrf(pool, grid22, G22, A0, nb)
    assert (perm[:n] < n).all(), "pivots stay in the valid row range"
    _ok(_lu_residual(A0, G, perm), np.float64)


def test_getrf_spmd_matches_lapack_pivoting(pool, rng, grid22):
    """The mesh pivots really pivot (a tiny natural diagonal), and are
    LAPACK's: the JAX package's panel is LAPACK's LU on the CPU."""
    n, nb = 32, 8
    A0 = _mk(rng, n, n)
    A0[np.arange(n), np.arange(n)] = 1e-14
    _getrf(pool, grid22, G22, A0, nb)
    X = _then(pool, G22, A0, nb, "lu.getrf", "lu.getri")
    _ok(checks.solve_residual(A0, X, np.eye(n)), np.float64, 100)


def test_getrf_distributed_4x2(pool, rng, grid42):
    n, nb = 64, 8
    A0 = _mk(rng, n, n)
    G, perm = _getrf(pool, grid42, G42, A0, nb)
    _ok(_lu_residual(A0, G, perm), np.float64)


def test_getrf_distributed_complex_4x2(pool, rng):
    """complex128 on the 4 x 2 mesh at a ragged n: LAPACK pivots complex
    columns by |re| + |im| and the port's panel by |z|, so perm is held to
    the port's single-device flat LU (the same panel rule) instead."""
    n, nb = 60, 8
    A0 = _mk(rng, n, n, np.complex128)
    R = _run(pool, G42, "lu.getrf", [_spec("Matrix", A0, nb)])
    LU, piv, info = R["out"]
    assert int(info) == 0 and R["fallbacks"] == {}
    Gp = np.zeros((64, 64), complex)
    Gp[:n, :n] = A0
    Gp[np.arange(n, 64), np.arange(n, 64)] = 1
    ref_lu, ref_perm = tlk.blocked_getrf(torch.from_numpy(Gp), nb)
    np.testing.assert_array_equal(piv["perm"], ref_perm.numpy())
    _near(LU["global"], ref_lu.numpy()[:n, :n], A0)
    _ok(_lu_residual(A0, LU["global"], piv["perm"]), np.complex128)


def test_gesv_distributed(pool, rng):
    n, nrhs = 96, 16
    A0, B0 = _mk(rng, n, n), _mk(rng, n, nrhs)
    R = _run(pool, G22, "lu.gesv", [_spec("Matrix", A0, 16), _spec("Matrix", B0, 16)])
    X, _, _, info = R["out"]
    assert int(info) == 0 and R["fallbacks"] == {}
    _ok(checks.solve_residual(A0, X["global"], B0), np.float64)
    np.testing.assert_allclose(X["global"], np.linalg.solve(A0, B0), atol=1e-10)


def test_gesv_calu_distributed(pool, rng, grid22):
    """CALU's factor and perm are the JAX package's mesh tournament's."""
    n, nb = 96, 16
    M0, B0 = rng.standard_normal((n, n)) + np.eye(n), rng.standard_normal((n, 4))
    _, perm = _getrf(pool, grid22, G22, M0, nb, CALU)
    R = _run(pool, G22, "lu.gesv", [_spec("Matrix", M0, nb), _spec("Matrix", B0, nb)],
             opts=CALU)
    X, _, piv, info = R["out"]
    assert int(info) == 0 and R["fallbacks"] == {}
    np.testing.assert_array_equal(piv["perm"], perm)
    _ok(checks.solve_residual(M0, X["global"], B0), np.float64, 100)


def test_getrf_calu_distributed_4x2(pool, rng, grid42):
    n, nb = 64, 8
    A0 = _mk(rng, n, n)
    G, perm = _getrf(pool, grid42, G42, A0, nb, CALU)
    _ok(_lu_residual(A0, G, perm), np.float64)


def test_getri_distributed(pool, rng):
    """The inverse solves against the identity through the mesh getrs."""
    n, nb = 48, 8
    A0 = _mk(rng, n, n) + n * np.eye(n)
    X = _then(pool, G42, A0, nb, "lu.getrf", "lu.getri")
    _ok(checks.solve_residual(A0, X, np.eye(n)), np.float64)
    np.testing.assert_allclose(X, np.linalg.inv(A0), atol=1e-14)


# -- QR (tests/test_qr.py) ---------------------------------------------------


def _geqrf(pool, jgrid, grid, A0, nb):
    jfac, jT = jqr.geqrf(_jmat("Matrix", A0, nb, jgrid))
    R = _run(pool, grid, "qr.geqrf", [_spec("Matrix", A0, nb)])
    fac, T = R["out"]
    assert R["fallbacks"] == {}
    _near(fac["global"], jfac.to_global(), A0)
    _near(T["T"], jT.T, A0)
    return fac["global"], _then(pool, grid, A0, nb, "qr.geqrf", "qr.ungqr")


@pytest.mark.parametrize("m,n,nb", [(96, 96, 16), (96, 64, 16), (64, 64, 8), (90, 70, 16),
                                    (75, 75, 8)])
def test_geqrf_distributed(pool, rng, grid22, m, n, nb):
    A0 = _mk(rng, m, n)
    fac, Q = _geqrf(pool, grid22, G22, A0, nb)
    R = np.triu(fac)[: min(m, n), :]
    _ok(checks.ortho_residual(Q), np.float64)
    _ok(checks.factor_residual(A0, Q, R), np.float64)


def test_geqrf_distributed_complex_4x2(pool, rng, grid42):
    m, n, nb = 64, 48, 8
    A0 = _mk(rng, m, n, np.complex128)
    fac, Q = _geqrf(pool, grid42, G42, A0, nb)
    _ok(checks.ortho_residual(Q), np.complex128)
    _ok(checks.factor_residual(A0, Q, np.triu(fac)[:n, :]), np.complex128)


def test_gels_distributed(pool, rng, grid22):
    m, n, nrhs = 96, 48, 8
    A0, B0 = _mk(rng, m, n), _mk(rng, m, nrhs)
    JX = jqr.gels(_jmat("Matrix", A0, 16, grid22), _jmat("Matrix", B0, 16, grid22))
    R = _run(pool, G22, "qr.gels", [_spec("Matrix", A0, 16), _spec("Matrix", B0, 16)])
    X = R["out"]["global"][:n]
    assert R["fallbacks"] == {}
    np.testing.assert_allclose(X, np.linalg.lstsq(A0, B0, rcond=None)[0], atol=1e-8)
    _near(X, np.asarray(JX.to_global())[:n], A0)


# -- the kernel routes through the SPMD bodies ------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_spmd_bodies_reach_the_kernel_routes(pool, rng, dtype):
    """With the resolvers answering as on a CUDA device, the mesh bodies
    call the kernel wrappers as their mirrors count, on every rank: each
    diagonal tile's Cholesky through chol_base / syrk_diag / gemm_sub
    (``spmd_chol.potrf_kernel_launches``; tiles of 32 and a crossover of
    8 so that all three run), one panel_lu a step of getrf, the CALU
    tournament's (``spmd_lu.tntpiv_kernel_launches``), one larft a step of
    geqrf; a complex operand calls none of them (library tile factor,
    plain panel and T)."""
    from slate_tpu_torch.parallel import spmd_chol, spmd_lu
    from slate_tpu_torch.parallel.layout import TileLayout

    n, nb = 96, 32
    A0 = _mk(rng, n, n, dtype)
    S0 = A0 @ A0.conj().T + n * np.eye(n)
    got = [r for r in pool.run("kernel_reach", grid=G42, a=A0, spd=S0, nb=nb,
                               opts={"BlockSize": 8}) if r is not None]
    lay = TileLayout(n, n, nb, nb, 4, 2)
    zero = dict.fromkeys(("chol_base", "syrk_diag", "gemm_sub", "panel_lu", "larft"), 0)
    if dtype == np.complex128:
        want = dict.fromkeys(("potrf", "getrf", "calu", "geqrf"), zero)
    else:
        chol = spmd_chol.potrf_kernel_launches(lay, 8)
        assert min(chol.values()) > 0
        want = {"potrf": {**zero, **chol}, "getrf": {**zero, "panel_lu": lay.nt},
                "calu": {**zero, "panel_lu": spmd_lu.tntpiv_kernel_launches(lay, 4)},
                "geqrf": {**zero, "larft": lay.nt}}
    assert got == [want] * 8



@pytest.mark.parametrize("m,n", [(70, 45), (45, 70)])
@pytest.mark.parametrize("routine", ["lu.getrf", "qr.geqrf"])
def test_tall_and_wide_on_a_row_ordered_2x4_mesh(pool, routine, m, n):
    """Ragged tall and wide operands on a 2 x 4 mesh in GridOrder.Row
    (tiles of 8): P A = L U and A = Q R (Q by ``ungqr`` on the mesh) within
    the reference tester's residuals, against numpy."""
    A0 = np.random.default_rng(m * n).standard_normal((m, n))
    grid, k = (2, 4, "Row", 8), min(m, n)
    R = _run(pool, grid, routine, [_spec("Matrix", A0, 8)])
    assert R["fallbacks"] == {}
    G = R["out"][0]["global"]
    if routine == "lu.getrf":
        perm = R["out"][1]["perm"]
        assert int(R["out"][2]) == 0 and sorted(perm[:m]) == list(range(m))
        err = checks.factor_residual(A0[perm[:m]], np.tril(G, -1)[:, :k] + np.eye(m, k),
                                     np.triu(G)[:k])
    else:
        Q = _then(pool, grid, A0, 8, "qr.geqrf", "qr.ungqr")
        _ok(checks.ortho_residual(Q), np.float64)
        err = checks.factor_residual(A0, Q, np.triu(G)[:k])
    _ok(err, np.float64)
