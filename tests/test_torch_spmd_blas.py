"""Port parity: hemm, symm and gemm of an op view on a mesh
(``parallel/spmd_blas.py`` and the mesh branches of
``drivers/blas3.py``), on gloo ranks against the JAX package's
8-virtual-device mesh and numpy.

The hemm / symm mesh cases of ``tests/test_blas3.py``, with their
parameters (its gemm cases are in test_torch_spmd_gemm.py, its herk /
her2k cases in test_torch_spmd_fallbacks.py).
The same seeded numpy operands go to the JAX package (on ``grid22`` /
``grid42``) and to a pool of 8 gloo ranks (``torch_mesh_pool``), where
each rank builds its blocks, runs the driver and gathers the result.
Tolerances: float64 within 1e-12 of the elementwise scale (|alpha| |A|
|B| + |beta| |C|) against both; ``fallbacks.counters()`` equal to the
JAX package's, route by route."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.drivers import blas3 as jblas3
from slate_tpu.internal import fallbacks as jfallbacks
from slate_tpu.matrix.base import conj_transpose as jconj_transpose
from torch_mesh_pool import MeshPool

torch.set_num_threads(1)

G22, G42 = (2, 2, "Col", 4), (4, 2, "Col", 8)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = MeshPool(8, tmp_path_factory.mktemp("mesh"))
    yield p
    p.close()


@pytest.fixture(autouse=True)
def _reset():
    jfallbacks.reset()
    yield
    jfallbacks.reset()


def _mk(rng, m, n, cplx=False):
    a = rng.standard_normal((m, n))
    return a + 1j * rng.standard_normal((m, n)) if cplx else a


def _jmat(kind, a, mb, grid, **kw):
    kw = {k: getattr(st, k.capitalize())[v] for k, v in kw.items()}
    return getattr(st, kind).from_global(jnp.asarray(a), mb, grid=grid, **kw)


def _spec(kind, a, mb, nb=None, **kw):
    return (kind, a, mb, nb, kw)


def _hold(got, jax_out, ref, scale):
    """port vs the JAX package and numpy within 1e-12 of the scale."""
    tol = 1e-12 * scale + 1e-300
    assert np.all(np.abs(got - np.asarray(jax_out)) <= tol), np.abs(got - jax_out).max()
    assert np.all(np.abs(got - ref) <= tol), np.abs(got - ref).max()


def _on_rank0(pool, grid, routine, args, **kw):
    res = pool.run("blas3", grid=grid, routine=routine, args=args, **kw)
    on = [r for r in res if r is not None]
    for r in on[1:]:  # every rank gathers the same matrix
        np.testing.assert_array_equal(r["global"], on[0]["global"])
        assert r["fallbacks"] == on[0]["fallbacks"]
    return on[0]


def test_gemm_transposed_view_on_the_square_mesh(pool, rng, grid22):
    """op(A) = A^H on a 2 x 2 mesh resolves onto the same grid (one
    exchange with the transposed partner) and rides SUMMA, as in the JAX
    package; a single-device B falls back and is recorded in both."""
    A0, B0, C0 = _mk(rng, 48, 64, True), _mk(rng, 48, 32, True), _mk(rng, 64, 32, True)
    ref = A0.conj().T @ B0 + 0.5 * C0
    scale = np.abs(A0).T @ np.abs(B0) + 0.5 * np.abs(C0)
    J = jblas3.gemm(1.0, jconj_transpose(_jmat("Matrix", A0, 16, grid22)),
                    _jmat("Matrix", B0, 16, grid22), 0.5, _jmat("Matrix", C0, 16, grid22))
    T = _on_rank0(pool, G22, "gemm", [1.0, _spec("Matrix", A0, 16, op="ConjTrans"),
                                      _spec("Matrix", B0, 16), 0.5, _spec("Matrix", C0, 16)])
    _hold(T["global"], J.to_global(), ref, scale)
    assert T["fallbacks"] == jfallbacks.counters() == {}
    J = jblas3.gemm(1.0, jconj_transpose(_jmat("Matrix", A0, 16, grid22)),
                    _jmat("Matrix", B0, 16, None), 0.5, _jmat("Matrix", C0, 16, grid22))
    T = _on_rank0(pool, G22, "gemm", [1.0, _spec("Matrix", A0, 16, op="ConjTrans"),
                                      _spec("Matrix", B0, 16, mesh=False), 0.5,
                                      _spec("Matrix", C0, 16)])
    _hold(T["global"], J.to_global(), ref, scale)
    assert T["fallbacks"] == jfallbacks.counters() == {"gemm": 1}


def _herm(rng, n, cplx=False):
    a = _mk(rng, n, n, cplx)
    return (a + a.conj().T) / 2


def test_hemm_distributed_spmd(pool, rng, grid22):
    n, w, nb = 64, 32, 16
    C0, B0 = _herm(rng, n), _mk(rng, n, w)
    J = jblas3.hemm(st.Side.Left, 2.0, _jmat("HermitianMatrix", C0, nb, grid22, uplo="Lower"),
                    _jmat("Matrix", B0, nb, grid22), 0.0,
                    _jmat("Matrix", np.zeros((n, w)), nb, grid22))
    T = _on_rank0(pool, G22, "hemm", ["Left", 2.0, _spec("HermitianMatrix", C0, nb, uplo="Lower"),
                                      _spec("Matrix", B0, nb), 0.0,
                                      _spec("Matrix", np.zeros((n, w)), nb)])
    _hold(T["global"], J.to_global(), 2.0 * C0 @ B0, 2.0 * np.abs(C0) @ np.abs(B0))
    assert T["fallbacks"] == jfallbacks.counters() == {}


def test_hemm_distributed_no_mirror(pool, rng):
    """The distributed hemm assembles A's panels from the stored
    triangle: full_global and to_global are never called."""
    n, w, nb = 64, 32, 16
    C0, B0 = _herm(rng, n), _mk(rng, n, w)
    T = _on_rank0(pool, G22, "hemm", ["Left", 1.0, _spec("HermitianMatrix", C0, nb, uplo="Lower"),
                                      _spec("Matrix", B0, nb), 0.0,
                                      _spec("Matrix", np.zeros((n, w)), nb)],
                  patch=[("HermitianMatrix", "full_global"), ("BaseMatrix", "to_global")])
    assert T["local_shape"] == (2, 1, nb, nb)
    np.testing.assert_allclose(T["global"], C0 @ B0, rtol=0, atol=1e-12 * n)


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
def test_hemm_right_distributed(pool, rng, grid42, uplo):
    n, w, nb = 64, 48, 8
    A0, B0, C0 = _herm(rng, n), _mk(rng, w, n), _mk(rng, w, n)
    J = jblas3.hemm(st.Side.Right, 1.5, _jmat("HermitianMatrix", A0, nb, grid42, uplo=uplo),
                    _jmat("Matrix", B0, nb, grid42), 0.5, _jmat("Matrix", C0, nb, grid42))
    T = _on_rank0(pool, G42, "hemm", ["Right", 1.5, _spec("HermitianMatrix", A0, nb, uplo=uplo),
                                      _spec("Matrix", B0, nb), 0.5, _spec("Matrix", C0, nb)])
    _hold(T["global"], J.to_global(), 1.5 * B0 @ A0 + 0.5 * C0,
          1.5 * np.abs(B0) @ np.abs(A0) + 0.5 * np.abs(C0))
    assert T["fallbacks"] == jfallbacks.counters() == {}


@pytest.mark.parametrize("kind", ["HermitianMatrix", "SymmetricMatrix"])
def test_hemm_symm_complex_distributed(pool, rng, grid22, kind):
    """Complex Hermitian hemm mirrors with conjugation; complex SYMMETRIC
    symm mirrors WITHOUT it."""
    n, w, nb = 48, 32, 16
    a = _mk(rng, n, n, True)
    A0 = (a + a.conj().T) / 2 if kind == "HermitianMatrix" else (a + a.T) / 2
    B0 = _mk(rng, n, w, True)
    routine = "hemm" if kind == "HermitianMatrix" else "symm"
    J = getattr(jblas3, routine)(st.Side.Left, 1.0, _jmat(kind, A0, nb, grid22, uplo="Lower"),
                                 _jmat("Matrix", B0, nb, grid22), 0.0,
                                 _jmat("Matrix", np.zeros((n, w), complex), nb, grid22))
    T = _on_rank0(pool, G22, routine, ["Left", 1.0, _spec(kind, A0, nb, uplo="Lower"),
                                       _spec("Matrix", B0, nb), 0.0,
                                       _spec("Matrix", np.zeros((n, w), complex), nb)])
    _hold(T["global"], J.to_global(), A0 @ B0, np.abs(A0) @ np.abs(B0))
    assert T["fallbacks"] == jfallbacks.counters() == {}


@pytest.mark.parametrize("two_stage", [False, True])
def test_lookahead_issues_step_k_plus_1_before_product_k(two_stage):
    """``spmd_blas._lookahead``: step k+1's gathers are issued before the
    caller computes step k and waited for only after it (a two-stage
    gather's first stage runs two steps ahead), and the steps come in
    order."""
    from slate_tpu_torch.parallel.spmd_blas import _lookahead

    log = []

    def wait(k):
        def done():
            log.append(("wait", k))
            return k
        return done

    def first(k):
        log.append(("first", k))
        return k if two_stage else wait(k)

    def second(k):
        log.append(("second", k))
        return wait(k)

    steps = 4
    got = []
    for k in _lookahead(steps, first, second if two_stage else None):
        log.append(("product", k))
        got.append(k)
    assert got == list(range(steps))
    at = {e: i for i, e in enumerate(log)}
    last = "second" if two_stage else "first"
    for k in range(steps - 1):
        assert at[(last, k + 1)] < at[("product", k)] < at[("wait", k + 1)]
        if two_stage and k + 2 < steps:
            assert at[("first", k + 2)] < at[("product", k)]
    assert sum(e[0] in ("first", "second") for e in log) == steps * (1 + two_stage)
