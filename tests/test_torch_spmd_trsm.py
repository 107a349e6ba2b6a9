"""Port parity: the mesh triangular solves and row permutation
(``parallel/spmd_trsm.py``) through ``trsm``, ``getrs``, ``posv`` and
``gesv``, on gloo ranks against the JAX package's 2 x 2 and 4 x 2
virtual meshes and numpy.

The cases of ``tests/test_trsm_spmd.py`` but its trmm ones (item 8a),
with their parameters, plus every side, storage triangle, op
(NoTrans / Trans / ConjTrans) and diagonal of trsm on a 2 x 2 mesh in
float64 and a 4 x 2 mesh in complex128 at a ragged n, held to numpy.
The same seeded numpy operands go to the JAX package and to a pool of 8
gloo ranks (``torch_mesh_pool``), where each rank builds its blocks,
runs the driver and gathers the result.
Tolerances: the scaled residual ||op(T) X - alpha B||_1 / (||T||_1
||X||_1 n eps) <= 3 (``checks.solve_residual``, the reference tester's
norm-scaled check); the port's X within 50 n eps ||X||_1 of the JAX
package's; permuted rows bitwise; no gather recorded."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.drivers import blas3 as jblas3
from slate_tpu.drivers import chol as jchol
from slate_tpu.drivers import lu as jlu
from slate_tpu.matrix.base import conj_transpose as jconj_transpose
from slate_tpu.matrix.base import transpose as jtranspose
from slate_tpu.parallel import spmd_trsm as jspmd_trsm
from slate_tpu.testing import checks
from torch_mesh_pool import MeshPool

torch.set_num_threads(1)

G22, G42 = (2, 2, "Col", 4), (4, 2, "Col", 8)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = MeshPool(8, tmp_path_factory.mktemp("mesh"))
    yield p
    p.close()


def _eps(a) -> float:
    return checks.eps_of(np.asarray(a).dtype)


def _spec(kind, a, mb, **kw):
    return (kind, a, mb, None, kw)


def _jmat(kind, a, mb, grid, **kw):
    kw = {k: getattr(st, k.capitalize())[v] for k, v in kw.items()}
    return getattr(st, kind).from_global(jnp.asarray(a), mb, grid=grid, **kw)


def _same(a, b):
    """Two ranks' packed outputs are equal, array for array."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def _on_ranks(pool, grid, routine, args, **kw):
    """Rank 0's answer to the driver case, after checking that every rank
    of the grid gathered the same output and fallback tally."""
    on = [r for r in pool.run("driver", grid=grid, routine=routine, args=args, **kw)
          if r is not None]
    for r in on[1:]:
        assert r["fallbacks"] == on[0]["fallbacks"]
        _same(r["out"], on[0]["out"])
    return on[0]


def _hold(X, J, M, B, alpha=1.0, left=True):
    """X solves op(T) X = alpha B (left) or X op(T) = alpha B: residual
    <= 3, and within 50 n eps ||X||_1 of the JAX package's J."""
    n = M.shape[0]
    if left:
        res = checks.solve_residual(M, X, alpha * B)
    else:
        res = checks.solve_residual(M.T, X.T, alpha * B.T)
    assert res <= 3 * _eps(X), res / _eps(X)
    if J is not None:
        J = np.asarray(J)
        tol = 50 * n * _eps(X) * np.abs(X).sum(0).max()
        assert np.abs(X - J).max() <= tol, (np.abs(X - J).max(), tol)


def _lower(rng, n, dtype=np.float64):
    L = np.tril(rng.standard_normal((n, n)))
    if np.dtype(dtype).kind == "c":
        L = L + 1j * np.tril(rng.standard_normal((n, n)))
    return (L + n * np.eye(n)).astype(dtype)


def _trsm(pool, jgrid, grid, side, alpha, T0, B0, nb, uplo="Lower", diag="NonUnit", op=None):
    """The port's and the JAX package's trsm of the same operands: (X,
    X_jax, fallbacks)."""
    J = _jmat("TriangularMatrix", T0, nb, jgrid, uplo=uplo, diag=diag)
    J = {None: J, "Trans": jtranspose(J), "ConjTrans": jconj_transpose(J)}[op]
    JX = jblas3.trsm(st.Side[side], alpha, J, _jmat("Matrix", B0, nb, jgrid)).to_global()
    kw = {"uplo": uplo, "diag": diag, **({"op": op} if op else {})}
    R = _on_ranks(pool, grid, "blas3.trsm", [side, alpha, _spec("TriangularMatrix", T0, nb, **kw),
                                             _spec("Matrix", B0, nb)])
    return R["out"]["global"], JX, R["fallbacks"]


@pytest.mark.parametrize("n,nb", [(64, 16), (50, 16), (72, 8)])
def test_trsm_lower_distributed(pool, rng, grid22, n, nb):
    L0, B0 = _lower(rng, n), rng.standard_normal((n, 12))
    X, J, fb = _trsm(pool, grid22, G22, "Left", 1.0, L0, B0, nb)
    _hold(X, J, L0, B0)
    np.testing.assert_allclose(X, np.linalg.solve(L0, B0), atol=1e-12)
    assert fb == {}


@pytest.mark.parametrize("alpha", [1.0, -2.5])
def test_trsm_upper_distributed(pool, rng, grid22, alpha):
    n, nb = 60, 16
    U0 = np.triu(rng.standard_normal((n, n))) + n * np.eye(n)
    B0 = rng.standard_normal((n, 8))
    X, J, fb = _trsm(pool, grid22, G22, "Left", alpha, U0, B0, nb, uplo="Upper")
    _hold(X, J, U0, B0, alpha)
    np.testing.assert_allclose(X, np.linalg.solve(U0, alpha * B0), atol=1e-12)
    assert fb == {}


def test_trsm_transposed_view_distributed(pool, rng, grid22):
    """L^T X = B runs the backward (row-gather) pipeline."""
    n, nb = 50, 16
    L0, B0 = _lower(rng, n), rng.standard_normal((n, 8))
    X, J, fb = _trsm(pool, grid22, G22, "Left", 1.0, L0, B0, nb, op="Trans")
    _hold(X, J, L0.T, B0)
    assert fb == {}


def test_trsm_conj_transpose_complex_distributed(pool, rng, grid42):
    n, nb = 64, 8
    L0 = _lower(rng, n, np.complex128)
    B0 = rng.standard_normal((n, 8)) + 1j * rng.standard_normal((n, 8))
    X, J, fb = _trsm(pool, grid42, G42, "Left", 1.0, L0, B0, nb, op="ConjTrans")
    _hold(X, J, L0.conj().T, B0)
    assert fb == {}


def test_trsm_unit_diag_distributed(pool, rng, grid22):
    """Diag.Unit: the stored diagonal (7.0) is ignored."""
    n, nb = 48, 16
    L0 = np.tril(rng.standard_normal((n, n)), -1)
    B0 = rng.standard_normal((n, 4))
    X, J, fb = _trsm(pool, grid22, G22, "Left", 1.0, L0 + 7.0 * np.eye(n), B0, nb, diag="Unit")
    _hold(X, J, L0 + np.eye(n), B0)
    assert fb == {}


def test_spmd_permute_rows(pool, rng, grid22):
    """New row i = old row perm[i], bitwise, as the JAX package's."""
    n, nb = 50, 16
    B0 = rng.standard_normal((n, 8))
    m_pad = 4 * nb  # P mb on the 2 x 2 mesh
    perm = np.arange(m_pad)
    rng.shuffle(perm[:n])  # padding rows stay in place
    got = [x for x in pool.run("permute_rows", grid=G22, b=B0, nb=nb, perm=perm)
           if x is not None]
    B = _jmat("Matrix", B0, nb, grid22)
    J = jspmd_trsm.spmd_permute_rows(grid22, B.data, B.layout, np.asarray(perm, np.int32))
    J = np.asarray(st.Matrix(J, B.layout, grid=grid22).to_global())
    for g in got:
        np.testing.assert_array_equal(g, B0[perm[:n]])
        np.testing.assert_array_equal(g, J)


def test_getrs_distributed_no_gather(pool, rng, grid22):
    """A distributed gesv solves through the permutation and the two
    SPMD trsm pipelines: spmd_trsm_left runs twice, nothing is gathered."""
    n, nb = 96, 16
    M0 = rng.standard_normal((n, n)) + n * np.eye(n)
    B0 = rng.standard_normal((n, 16))
    JX, _, _, _ = jlu.gesv(_jmat("Matrix", M0, nb, grid22), _jmat("Matrix", B0, nb, grid22))
    R = _on_ranks(pool, G22, "lu.gesv", [_spec("Matrix", M0, nb), _spec("Matrix", B0, nb)],
                  calls=("spmd_trsm.spmd_trsm_left", "spmd_trsm.spmd_permute_rows"))
    X, _, _, info = R["out"]
    assert int(info) == 0 and R["fallbacks"] == {}
    assert R["calls"] == {"spmd_trsm.spmd_trsm_left": 2, "spmd_trsm.spmd_permute_rows": 1}
    _hold(X["global"], JX.to_global(), M0, B0)


def test_posv_distributed_spmd_solve(pool, rng, grid22):
    n, nb = 96, 16
    A0 = rng.standard_normal((n, n))
    A0 = A0 @ A0.T + n * np.eye(n)
    B0 = rng.standard_normal((n, 8))
    JX, _, _ = jchol.posv(_jmat("HermitianMatrix", A0, nb, grid22, uplo="Lower"),
                          _jmat("Matrix", B0, nb, grid22))
    R = _on_ranks(pool, G22, "chol.posv", [_spec("HermitianMatrix", A0, nb, uplo="Lower"),
                                           _spec("Matrix", B0, nb)],
                  calls=("spmd_trsm.spmd_trsm_left",))
    X, _, info = R["out"]
    assert int(info) == 0 and R["fallbacks"] == {}
    assert R["calls"] == {"spmd_trsm.spmd_trsm_left": 2}
    _hold(X["global"], JX.to_global(), A0, B0)


def test_gesv_distributed_ragged(pool, rng, grid42):
    n, nb = 90, 16  # a ragged last tile across a 4 x 2 grid
    M0 = rng.standard_normal((n, n)) + n * np.eye(n)
    B0 = rng.standard_normal((n, 4))
    JX, _, jpiv, _ = jlu.gesv(_jmat("Matrix", M0, nb, grid42), _jmat("Matrix", B0, nb, grid42))
    R = _on_ranks(pool, G42, "lu.gesv", [_spec("Matrix", M0, nb), _spec("Matrix", B0, nb)])
    X, _, piv, info = R["out"]
    assert int(info) == 0 and R["fallbacks"] == {}
    np.testing.assert_array_equal(piv["perm"], np.asarray(jpiv.perm))
    _hold(X["global"], JX.to_global(), M0, B0)


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("opname", ["n", "t"])
def test_trsm_right_ops_distributed(pool, rng, grid22, uplo, opname):
    n, nb = 50, 16
    T0 = rng.standard_normal((n, n))
    T0 = (np.tril(T0) if uplo == "Lower" else np.triu(T0)) + n * np.eye(n)
    B0 = rng.standard_normal((8, n))
    op = None if opname == "n" else "Trans"
    X, J, fb = _trsm(pool, grid22, G22, "Right", 1.0, T0, B0, nb, uplo=uplo, op=op)
    _hold(X, J, T0 if opname == "n" else T0.T, B0, left=False)
    assert fb == {}


def test_trsm_right_complex_conj_distributed(pool, rng, grid42):
    n, nb = 64, 8
    T0 = np.tril(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))) + n * np.eye(n)
    B0 = rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
    X, J, fb = _trsm(pool, grid42, G42, "Right", 1.0, T0, B0, nb, op="ConjTrans")
    _hold(X, J, T0.conj().T, B0, left=False)
    assert fb == {}


def test_trsm_right_unit_diag_distributed(pool, rng, grid22):
    n, nb = 48, 16
    T0 = np.tril(rng.standard_normal((n, n)), -1)
    B0 = rng.standard_normal((6, n))
    X, J, fb = _trsm(pool, grid22, G22, "Right", 1.0, T0 + np.eye(n), B0, nb, diag="Unit")
    _hold(X, J, T0 + np.eye(n), B0, left=False)
    assert fb == {}


@pytest.mark.parametrize("diag", ["NonUnit", "Unit"])
@pytest.mark.parametrize("op", [None, "Trans", "ConjTrans"])
@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("side", ["Left", "Right"])
@pytest.mark.parametrize("mesh", ["2x2 float64 n=64", "4x2 complex128 n=45"])
def test_trsm_every_variant_against_numpy(pool, mesh, side, uplo, op, diag):
    """Every side, storage triangle, op and diagonal: float64 on the 2 x 2
    mesh, complex128 at a ragged n on the 4 x 2 mesh, alpha = -1.5
    (0.5 + 2j in complex), held to numpy; no gather recorded."""
    cplx = "complex" in mesh
    rng = np.random.default_rng(zlib.crc32(f"{mesh} {side} {uplo} {op} {diag}".encode()))
    n, nb, grid = (45, 8, G42) if cplx else (64, 16, G22)
    T0 = rng.standard_normal((n, n)) + (1j * rng.standard_normal((n, n)) if cplx else 0)
    T0 = (np.tril(T0) if uplo == "Lower" else np.triu(T0)) + n * np.eye(n)
    shape = (n, 6) if side == "Left" else (6, n)
    B0 = rng.standard_normal(shape) + (1j * rng.standard_normal(shape) if cplx else 0)
    alpha = 0.5 + 2j if cplx else -1.5
    kw = {"uplo": uplo, "diag": diag, **({"op": op} if op else {})}
    R = _on_ranks(pool, grid, "blas3.trsm", [side, alpha, _spec("TriangularMatrix", T0, nb, **kw),
                                             _spec("Matrix", B0, nb)])
    M = T0 - np.diag(np.diag(T0)) + np.eye(n) if diag == "Unit" else T0
    M = {None: M, "Trans": M.T, "ConjTrans": M.conj().T}[op]
    _hold(R["out"]["global"], None, M, B0, alpha, left=side == "Left")
    assert R["fallbacks"] == {}
