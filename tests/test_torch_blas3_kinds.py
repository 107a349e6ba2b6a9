"""Port parity: the level-3 BLAS kinds of slate_tpu_torch beyond gemm,
herk/syrk and trsm — ``symm``/``hemm``, ``syr2k``/``her2k`` and ``trmm``
(drivers and ``ops/blas2d``) — against the JAX package on the CPU.

The same seeded numpy inputs go through both packages.  Tolerance:
``50 n eps max|ref|``, as in tests/test_torch_blas.py."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu.drivers import blas3 as jblas3
from slate_tpu.ops import blas2d as jb
from slate_tpu_torch.drivers import blas3 as tblas3
from slate_tpu_torch.ops import blas2d as tb

torch.set_num_threads(1)

CPU = stt.ProcessGrid.single("cpu")
COMBOS = list(itertools.product(["Left", "Right"], ["Lower", "Upper"],
                                ["NoTrans", "Trans", "ConjTrans"], ["NonUnit", "Unit"]))


def _tol(n, ref):
    return 50 * n * np.finfo(np.float64).eps * max(float(np.abs(ref).max()), 1.0)


def _data(rng, m, n, cplx):
    a = rng.standard_normal((m, n))
    return a + 1j * rng.standard_normal((m, n)) if cplx else a


def _close(got, ref, n):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=_tol(n, ref))


def _both(cls_name, a, nb, grid11, **kw):
    jk = {k: getattr(st, type(v).__name__)[v.name] for k, v in kw.items()}
    J = getattr(st, cls_name).from_global(jnp.asarray(a), nb, grid=grid11, **jk)
    T = getattr(stt, cls_name).from_global(a, nb, grid=CPU, **kw)
    return J, T


@pytest.mark.parametrize("cplx", [False, True])
def test_rank2_and_trmm_2d_match_jax(cplx):
    rng = np.random.default_rng(3 + cplx)
    a, b, c = _data(rng, 12, 5, cplx), _data(rng, 12, 5, cplx), _data(rng, 12, 12, cplx)
    alpha = 1.5 - 0.5j if cplx else 1.5
    ja, jbb, jc = (jnp.asarray(x) for x in (a, b, c))
    ta, tbb, tc = (torch.from_numpy(x) for x in (a, b, c))
    _close(tb.syr2k2d(alpha, ta, tbb, -0.5, tc), jb.syr2k2d(alpha, ja, jbb, -0.5, jc), 5)
    _close(tb.her2k2d(alpha, ta, tbb, -0.5, tc), jb.her2k2d(alpha, ja, jbb, -0.5, jc), 5)
    # a tensor alpha conjugates the same way
    _close(tb.her2k2d(torch.tensor(alpha), ta, tbb, -0.5, tc),
           jb.her2k2d(alpha, ja, jbb, -0.5, jc), 5)
    sq, rhs = _data(rng, 12, 12, cplx), _data(rng, 12, 7, cplx)
    for side, uplo, op, diag in COMBOS:
        args = (st.Side[side], st.Uplo[uplo], st.Op[op], st.Diag[diag])
        targs = (stt.Side[side], stt.Uplo[uplo], stt.Op[op], stt.Diag[diag])
        B = rhs if side == "Left" else rhs.T.copy()
        _close(tb.trmm2d(*targs, 2.0, torch.from_numpy(sq), torch.from_numpy(B)),
               jb.trmm2d(*args, 2.0, jnp.asarray(sq), jnp.asarray(B)), 12)


@pytest.mark.parametrize("kind", ["symm", "hemm"])
@pytest.mark.parametrize("side", ["Left", "Right"])
@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("cplx", [False, True])
def test_symm_hemm_match_jax(kind, side, uplo, cplx, grid11):
    """The shapes of tests/test_blas3.py::test_symm_hemm (48 x 48, tiles
    of 16), junk in the triangle that is not stored."""
    n, m, nb = 48, 40, 16
    rng = np.random.default_rng(len(kind) + 3 * len(side) + 7 * len(uplo) + cplx)
    s = _data(rng, n, n, cplx)
    b = _data(rng, n, m, cplx) if side == "Left" else _data(rng, m, n, cplx)
    c = _data(rng, *b.shape, cplx)
    cls = "SymmetricMatrix" if kind == "symm" else "HermitianMatrix"
    JA, TA = _both(cls, s, nb, grid11, uplo=stt.Uplo[uplo])
    JB, TB = _both("Matrix", b, nb, grid11)
    JC, TC = _both("Matrix", c, nb, grid11)
    alpha = 2.0 - 1.0j if cplx else 2.0
    ref = getattr(jblas3, kind)(st.Side[side], alpha, JA, JB, 0.5, JC).to_global()
    got = getattr(tblas3, kind)(stt.Side[side], alpha, TA, TB, 0.5, TC)
    assert isinstance(got, stt.Matrix) and got.layout == TC.layout
    _close(got.to_global().numpy(), ref, n)


def test_hemm_checks_dims():
    A = stt.HermitianMatrix.from_global(np.eye(8), 4, grid=CPU)
    B = stt.Matrix.from_global(np.ones((6, 3)), 4, grid=CPU)
    C = stt.Matrix.from_global(np.ones((8, 3)), 4, grid=CPU)
    with pytest.raises(stt.DimensionError):
        stt.hemm(stt.Side.Left, 1.0, A, B, 0.0, C)
    with pytest.raises(stt.DimensionError):
        stt.symm(stt.Side.Right, 1.0, A, B, 0.0, C)


@pytest.mark.parametrize("kind", ["syr2k", "her2k"])
@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("view", [False, True])
def test_syr2k_her2k_match_jax(kind, uplo, cplx, view, grid11):
    """tests/test_blas3.py::test_syr2k_her2k's shapes (n = 32, k = 16,
    tiles of 8); with ``view`` A and B come as transposed views of
    (k, n) matrices and C as a transposed view, which repacks with the
    transposed layout."""
    n, k, nb = 32, 16, 8
    rng = np.random.default_rng(len(kind) + 5 * len(uplo) + 11 * cplx + 17 * view)
    a, b = _data(rng, n, k, cplx), _data(rng, n, k, cplx)
    c = _data(rng, n, n, cplx)
    c = c + c.conj().T if kind == "her2k" else c + c.T
    cls = "SymmetricMatrix" if kind == "syr2k" else "HermitianMatrix"
    if view:
        JA, TA = _both("Matrix", a.T.copy(), nb, grid11)
        JB, TB = _both("Matrix", b.T.copy(), nb, grid11)
        JA, TA, JB, TB = st.transpose(JA), stt.transpose(TA), st.transpose(JB), stt.transpose(TB)
        JC, TC = _both(cls, c.T.copy(), nb, grid11, uplo=stt.Uplo[uplo])
        JC, TC = st.transpose(JC), stt.transpose(TC)
    else:
        JA, TA = _both("Matrix", a, nb, grid11)
        JB, TB = _both("Matrix", b, nb, grid11)
        JC, TC = _both(cls, c, nb, grid11, uplo=stt.Uplo[uplo])
    alpha = 0.75 + 0.25j if cplx else 0.75
    ref = getattr(jblas3, kind)(alpha, JA, JB, 1.0, JC)
    got = getattr(tblas3, kind)(alpha, TA, TB, 1.0, TC)
    assert type(got).__name__ == type(ref).__name__ and got.op == stt.Op.NoTrans
    _close(got.to_global().numpy(), ref.to_global(), k)


def test_syr2k_checks_dims():
    A = stt.Matrix.from_global(np.ones((8, 3)), 4, grid=CPU)
    B = stt.Matrix.from_global(np.ones((8, 4)), 4, grid=CPU)
    C = stt.SymmetricMatrix.from_global(np.eye(8), 4, grid=CPU)
    with pytest.raises(stt.DimensionError):
        stt.syr2k(1.0, A, B, 0.0, C)
    with pytest.raises(stt.DimensionError):
        stt.her2k(1.0, A, B, 0.0, C)


@pytest.mark.parametrize("side,uplo,op,diag", COMBOS)
def test_trmm_driver_matches_jax(side, uplo, op, diag, grid11):
    """Every Side/Uplo/Op/Diag combination, A as an op view of a
    triangular matrix whose other triangle (and, for Unit, diagonal)
    holds junk that must not be read."""
    n, k, nb = 20, 6, 8
    cplx = op == "ConjTrans"
    rng = np.random.default_rng(len(side) * 7 + len(uplo) * 3 + len(op) + len(diag))
    a = _data(rng, n, n, cplx)
    b = _data(rng, n, k, cplx) if side == "Left" else _data(rng, k, n, cplx)
    JA, TA = _both("TriangularMatrix", a, nb, grid11, uplo=stt.Uplo[uplo], diag=stt.Diag[diag])
    JB, TB = _both("Matrix", b, nb, grid11)
    jview = {"NoTrans": lambda M: M, "Trans": st.transpose, "ConjTrans": st.conj_transpose}[op]
    tview = {"NoTrans": lambda M: M, "Trans": stt.transpose,
             "ConjTrans": stt.conj_transpose}[op]
    ref = jblas3.trmm(st.Side[side], 2.0, jview(JA), JB).to_global()
    got = tblas3.trmm(stt.Side[side], 2.0, tview(TA), TB)
    _close(got.to_global().numpy(), ref, n)


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("op", ["NoTrans", "Trans", "ConjTrans"])
def test_resolve_tri_matches_jax(uplo, op, grid11):
    a = _data(np.random.default_rng(9), 12, 12, True)
    JA, TA = _both("TriangularMatrix", a, 4, grid11, uplo=stt.Uplo[uplo])
    jview = {"NoTrans": lambda M: M, "Trans": st.transpose, "ConjTrans": st.conj_transpose}[op]
    tview = {"NoTrans": lambda M: M, "Trans": stt.transpose,
             "ConjTrans": stt.conj_transpose}[op]
    jg, juplo, jop = jblas3._resolve_tri(jview(JA))
    tg, tuplo, top = tblas3._resolve_tri(tview(TA))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert (tuplo.name, top.name) == (juplo.name, jop.name)
