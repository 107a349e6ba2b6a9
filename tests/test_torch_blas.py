"""Port parity: the global-path BLAS of slate_tpu_torch (``ops/blas2d``
and the ``trsm`` driver) against the JAX package, for every
Side/Uplo/Op/Diag combination, on the CPU.

The same seeded numpy inputs go through both packages.  Tolerance:
``50 n eps max|ref|``, as in tests/test_pallas_panels.py."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu.ops import blas2d as jb
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


def _tri_operand(rng, n, cplx):
    """Well conditioned on both triangles (either may be the one read),
    with NaN-free junk in the other; the diagonal stays away from 0."""
    a = _data(rng, n, n, cplx) * 0.3
    return a + np.diag(2.0 + np.abs(rng.standard_normal(n)))


@pytest.mark.parametrize("cplx", [False, True])
def test_gemm2d_apply_op_tri_take_match_jax(cplx):
    rng = np.random.default_rng(1 + cplx)
    a, b, c = _data(rng, 9, 6, cplx), _data(rng, 6, 7, cplx), _data(rng, 9, 7, cplx)
    alpha, beta = 1.5, -0.5
    ref = np.asarray(jb.gemm2d(alpha, jnp.asarray(a), jnp.asarray(b), beta, jnp.asarray(c)))
    got = tb.gemm2d(alpha, *(torch.from_numpy(x) for x in (a, b)), beta, torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_tol(6, ref))
    sq = _data(rng, 8, 8, cplx)
    for op in stt.Op:
        np.testing.assert_array_equal(
            tb.apply_op(torch.from_numpy(sq), op).resolve_conj().numpy(),
            np.asarray(jb.apply_op(jnp.asarray(sq), st.Op[op.name])))
    for uplo, diag in itertools.product(["Lower", "Upper"], ["NonUnit", "Unit"]):
        np.testing.assert_array_equal(
            tb._tri_take(torch.from_numpy(sq), stt.Uplo[uplo], stt.Diag[diag]).numpy(),
            np.asarray(jb._tri_take(jnp.asarray(sq), st.Uplo[uplo], st.Diag[diag])))


@pytest.mark.parametrize("side,uplo,op,diag", COMBOS)
def test_trsm2d_and_trsm_driver_match_jax(side, uplo, op, diag, grid11):
    n, k, nb = 20, 5, 8
    cplx = op == "ConjTrans"
    rng = np.random.default_rng(len(side) * 7 + len(uplo) * 3 + len(op) + len(diag))
    a = _tri_operand(rng, n, cplx)
    b = _data(rng, n, k, cplx) if side == "Left" else _data(rng, k, n, cplx)
    jargs = (st.Side[side], st.Uplo[uplo], st.Op[op], st.Diag[diag])
    targs = (stt.Side[side], stt.Uplo[uplo], stt.Op[op], stt.Diag[diag])
    ref = np.asarray(jb.trsm2d(*jargs, 2.0, jnp.asarray(a), jnp.asarray(b)))
    got = tb.trsm2d(*targs, 2.0, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(n, ref))

    # the driver, with A given as an op view of a triangular matrix
    JA = st.TriangularMatrix.from_global(jnp.asarray(a), nb, grid=grid11,
                                         uplo=st.Uplo[uplo], diag=st.Diag[diag])
    TA = stt.TriangularMatrix.from_global(a, nb, grid=CPU, uplo=stt.Uplo[uplo],
                                          diag=stt.Diag[diag])
    view = {"NoTrans": lambda M, m: M, "Trans": lambda M, m: m.transpose(M),
            "ConjTrans": lambda M, m: m.conj_transpose(M)}[op]
    JX = st.trsm(st.Side[side], 2.0, view(JA, st), st.Matrix.from_global(jnp.asarray(b), nb,
                                                                          grid=grid11))
    TX = stt.trsm(stt.Side[side], 2.0, view(TA, stt), stt.Matrix.from_global(b, nb, grid=CPU))
    ref = np.asarray(JX.to_global())
    np.testing.assert_allclose(TX.to_global().numpy(), ref, rtol=0, atol=_tol(n, ref))
