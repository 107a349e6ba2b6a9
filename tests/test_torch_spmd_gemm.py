"""Port parity: gemm on a mesh (``spmd_blas.summa_gemm`` and
``gemm_reduce_a`` through ``drivers/blas3.py``), on gloo ranks against
the JAX package's 8-virtual-device mesh and numpy.

The gemm mesh cases of ``tests/test_blas3.py``, with their parameters
(each JAX mesh gemm traces for about 6 s on the CPU, so the other BLAS3
cases are in test_torch_spmd_blas.py and test_torch_spmd_fallbacks.py).
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


@pytest.mark.parametrize("method", ["C", "A"])
@pytest.mark.parametrize("mnk", [(96, 96, 96), (80, 48, 64), (90, 54, 70)])
def test_gemm_distributed(pool, rng, grid22, method, mnk):
    m, n, k = mnk
    A0, B0, C0 = _mk(rng, m, k), _mk(rng, k, n), _mk(rng, m, n)
    J = jblas3.gemm(1.5, _jmat("Matrix", A0, 16, grid22), _jmat("Matrix", B0, 16, grid22), 0.5,
                    _jmat("Matrix", C0, 16, grid22),
                    opts={st.Option.MethodGemm: st.MethodGemm[method]})
    T = _on_rank0(pool, G22, "gemm", [1.5, _spec("Matrix", A0, 16), _spec("Matrix", B0, 16),
                                      0.5, _spec("Matrix", C0, 16)],
                  opts={"MethodGemm": method})
    _hold(T["global"], J.to_global(), 1.5 * A0 @ B0 + 0.5 * C0,
          1.5 * np.abs(A0) @ np.abs(B0) + 0.5 * np.abs(C0))
    assert T["fallbacks"] == jfallbacks.counters() == {}
    # the distribution is kept: each rank holds its block of C's layout
    lay = J.layout
    assert T["layout"] == (lay.m, lay.n, lay.mb, lay.nb, lay.p, lay.q)
    assert T["local_shape"] == (lay.mtl, lay.ntl, lay.mb, lay.nb)


def test_gemm_distributed_4x2(pool, rng, grid42):
    m, n, k = 64, 64, 96
    A0, B0, C0 = _mk(rng, m, k), _mk(rng, k, n), _mk(rng, m, n)
    J = jblas3.gemm(1.0, _jmat("Matrix", A0, 8, grid42), _jmat("Matrix", B0, 8, grid42), 0.0,
                    _jmat("Matrix", C0, 8, grid42))
    T = _on_rank0(pool, G42, "gemm", [1.0, _spec("Matrix", A0, 8), _spec("Matrix", B0, 8), 0.0,
                                      _spec("Matrix", C0, 8)])
    _hold(T["global"], J.to_global(), A0 @ B0, np.abs(A0) @ np.abs(B0))
    assert T["fallbacks"] == jfallbacks.counters() == {}
