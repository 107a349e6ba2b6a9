"""Port parity: the auxiliary drivers on a mesh (``drivers/aux.py``'s
``norm`` / ``colNorms`` through ``internal/norms.py``'s explicit mesh
reductions, the elementwise ``set`` / ``set_lambdas`` / ``scale`` /
``scale_row_col`` / ``add`` / ``copy`` on each rank's block,
``redistribute`` with ``parallel/spmd_redistribute.py``,
``print_matrix``) and hemm's dimension check, on gloo ranks against the
JAX package's 8-virtual-device mesh and numpy.

The mesh cases of ``tests/test_aux.py`` (its ``aux/debug.py`` dump waits
for that module, ROADMAP.md Queue 1 item 9a).  The same seeded numpy
operands go to the JAX package (on ``grid22``) and to a pool of 4 gloo
ranks (``torch_mesh_pool``).  The Max norm must be bitwise the JAX
package's and numpy's; the other norms within 1e-13 of them (the sums
reduce in another order); redistribute moves elements bitwise; the
fallback tallies match the JAX package's route by route."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.drivers import aux as jaux
from slate_tpu.drivers import blas3 as jblas3
from slate_tpu.internal import fallbacks as jfallbacks
from slate_tpu.matrix.base import transpose as jtranspose
from torch_mesh_pool import MeshPool

torch.set_num_threads(1)

G22 = (2, 2, "Col", 4)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = MeshPool(4, tmp_path_factory.mktemp("mesh"))
    yield p
    p.close()


@pytest.fixture(autouse=True)
def _reset():
    jfallbacks.reset()
    yield
    jfallbacks.reset()


def _first(res):
    return next(x for x in res if x is not None)


def _np_norms(a):
    return {"Max": np.abs(a).max(), "One": np.abs(a).sum(0).max(),
            "Inf": np.abs(a).sum(1).max(), "Fro": np.linalg.norm(a, "fro")}


@pytest.mark.parametrize("cplx", [False, True])
def test_norm_distributed_matches(pool, rng, grid22, cplx):
    """Max / One / Inf / Fro and the column and row sums of a matrix on
    the mesh: the port's tile_norms route plus the explicit mesh
    reduction against the JAX package's GSPMD reduction and numpy."""
    A0 = rng.standard_normal((64, 64)) + (1j * rng.standard_normal((64, 64)) if cplx else 0)
    JA = st.Matrix.from_global(jnp.asarray(A0), 16, grid=grid22)
    res = [x for x in pool.run("norms", grid=G22, spec=("Matrix", A0, 16, None, {}), scopes=True)
           if x is not None]
    ref = _np_norms(A0)
    for x in res:
        for k in ("Max", "One", "Inf", "Fro"):
            j = float(jaux.norm(st.Norm[k], JA))
            if k == "Max":
                assert float(x[k]) == j == ref[k]
            else:
                np.testing.assert_allclose(float(x[k]), j, rtol=1e-13)
                np.testing.assert_allclose(float(x[k]), ref[k], rtol=1e-13)
        np.testing.assert_allclose(x["cols"], np.asarray(jaux.colNorms(st.Norm.One, JA)),
                                   rtol=1e-13)
        np.testing.assert_allclose(x["rows"], np.abs(A0).sum(1), rtol=1e-13)


@pytest.mark.parametrize("kind,uplo,diag", [
    ("HermitianMatrix", "Lower", None), ("SymmetricMatrix", "Upper", None),
    ("TriangularMatrix", "Lower", "Unit"), ("TriangularMatrix", "Upper", "NonUnit"),
])
def test_structured_norms_on_the_mesh(pool, rng, grid22, kind, uplo, diag):
    """The Hermitian, symmetric and triangular norms on the mesh (masked
    local reductions, then the mesh's) against the JAX package and numpy."""
    n = 45
    A0 = rng.standard_normal((n, n))
    kw = {"uplo": uplo} if diag is None else {"uplo": uplo, "diag": diag}
    JA = getattr(st, kind).from_global(
        jnp.asarray(A0), 8, grid=grid22,
        **{k: getattr(st, k.capitalize())[v] for k, v in kw.items()})
    if kind == "TriangularMatrix":
        full = np.tril(A0) if uplo == "Lower" else np.triu(A0)
        if diag == "Unit":
            np.fill_diagonal(full, 1.0)
    else:
        t = np.tril(A0) if uplo == "Lower" else np.triu(A0)
        full = t + t.T - np.diag(np.diag(t))
    ref = _np_norms(full)
    x = _first(pool.run("norms", grid=G22, spec=(kind, A0, 8, None, kw)))
    for k in ("Max", "One", "Inf", "Fro"):
        j = float(jaux.norm(st.Norm[k], JA))
        if k == "Max":
            assert float(x[k]) == j == ref[k]
        else:
            np.testing.assert_allclose(float(x[k]), j, rtol=1e-13)
            np.testing.assert_allclose(float(x[k]), ref[k], rtol=1e-13)


def _cdiv(a, b):
    return -(-a // b)


def _jspec(grid, spec):
    """The JAX package's matrix for a pool matrix spec."""
    kind, a, mb, nb, kw = spec
    kw = {k: getattr(st, k.capitalize())[v] for k, v in kw.items()}
    return getattr(st, kind).from_global(jnp.asarray(a), mb, nb, grid=grid, **kw)


def _aux_case(rng, routine):
    """(args for the pool, the JAX call's args builder, numpy's result)."""
    A0, B0 = rng.standard_normal((50, 37)), rng.standard_normal((50, 37))
    G = ("Matrix", A0, 16, 8, {})
    L0 = ("TriangularMatrix", A0[:37], 8, None, {"uplo": "Lower"})
    LB = ("TriangularMatrix", B0[:37], 8, None, {"uplo": "Lower"})
    R, C = np.arange(1.0, 51.0), np.arange(1.0, 38.0) / 7
    i, j = np.meshgrid(np.arange(50), np.arange(37), indexing="ij")
    lower, low = np.tril(np.ones((37, 37), bool)), np.tril(np.ones((37, 37), bool), -1)
    eye = np.eye(50, 37)
    return {
        "set": ([0.5, 2.0, G], np.where(eye == 1, 2.0, 0.5)),
        "set_tz": ([0.5, 2.0, L0], np.where(np.eye(37) == 1, 2.0, np.where(low, 0.5, A0[:37]))),
        "set_lambdas": (["i+10j", ("Matrix", np.zeros((50, 37)), 16, 8, {})],
                        (i + 10 * j).astype(float)),
        "scale": ([3.0, 2.0, G], A0 * 1.5),
        "scale_tz": ([3.0, 2.0, L0], np.where(lower, A0[:37] * 1.5, A0[:37])),
        "scale_row_col": ([R, C, G], np.diag(R) @ A0 @ np.diag(C)),
        "add": ([2.0, G, -1.0, ("Matrix", B0, 16, 8, {})], 2 * A0 - B0),
        "add_tz": ([1.0, L0, 1.0, LB], np.where(lower, A0[:37] + B0[:37], B0[:37])),
        "add_layouts": ([2.0, G, -1.0, ("Matrix", B0, 8, 16, {})], 2 * A0 - B0),
        "copy_layouts": ([G, ("Matrix", np.zeros((50, 37)), 8, 8, {})], A0),
        "copy_f32": ([G, ("Matrix", np.zeros((50, 37), np.float32), 16, 8, {})],
                     A0.astype(np.float32)),
    }[routine]


@pytest.mark.parametrize("routine", ["set", "set_tz", "set_lambdas", "scale", "scale_tz",
                                     "scale_row_col", "add", "add_tz", "add_layouts",
                                     "copy_layouts", "copy_f32"])
def test_elementwise_on_the_mesh(pool, rng, grid22, routine):
    """Each elementwise driver on a distributed operand acts on the rank's
    block (its masks and index maps those of the block) and keeps the
    distribution; the result is the JAX package's on its mesh and
    numpy's, and nothing falls back."""
    args, ref = _aux_case(rng, routine)
    name = routine.split("_tz")[0].split("_layouts")[0].split("_f32")[0]
    jargs = [_jspec(grid22, a) if isinstance(a, tuple)
             else (lambda i, j: (i + 10 * j).astype(jnp.float64)) if isinstance(a, str)
             else jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    J = np.asarray(getattr(jaux, name)(*jargs).to_global())
    res = pool.run("aux", grid=G22, routine=name, args=args)
    for x in res:
        assert x["global"].dtype == ref.dtype
        scale = np.abs(ref) + 1.0
        assert np.all(np.abs(x["global"] - ref) <= 1e-12 * scale)
        assert np.all(np.abs(x["global"] - J) <= 1e-12 * scale)
        m, n, mb, nb = x["layout"][:4]
        assert x["local_shape"] == (_cdiv(_cdiv(m, mb), 2), _cdiv(_cdiv(n, nb), 2), mb, nb)
        assert x["fallbacks"] == {}
    np.testing.assert_array_equal(res[1]["global"], res[0]["global"])


def test_redistribute(pool, rng, grid22):
    """A single-device A into a 2 x 2 mesh's layout: the gather route,
    recorded as in the JAX package."""
    A0 = rng.standard_normal((48, 48))
    J = jaux.redistribute(st.Matrix.from_global(jnp.asarray(A0), 16),
                          st.Matrix.zeros(48, 48, 8, grid=grid22, dtype=jnp.float64))
    x = _first(pool.run("redistribute", grid=G22, src=("Matrix", A0, 16, None, {"mesh": False}),
                        dst=("Matrix", np.zeros((48, 48)), 8, None, {})))
    np.testing.assert_array_equal(x["global"], A0)
    np.testing.assert_array_equal(x["global"], np.asarray(J.to_global()))
    assert x["layout"][4:] == (2, 2) and x["local_shape"] == (3, 3, 8, 8)
    assert x["fallbacks"] == jfallbacks.counters() == {"redistribute": 1}


@pytest.mark.parametrize("shape,src,dst", [
    ((50, 37), (16, 16), (8, 8)),  # ragged last tiles both sides
    ((40, 30), (16, 9), (8, 16)),  # rectangular, different aspect
])
def test_redistribute_edge_tilings(pool, rng, grid22, shape, src, dst):
    m, n = shape
    A0 = rng.standard_normal((m, n))
    J = jaux.redistribute(st.Matrix.from_global(jnp.asarray(A0), src[0], src[1], grid=grid22),
                          st.Matrix.from_global(jnp.zeros((m, n)), dst[0], dst[1]))
    x = _first(pool.run("redistribute", grid=G22, src=("Matrix", A0, src[0], src[1], {}),
                        dst=("Matrix", np.zeros((m, n)), dst[0], dst[1], {"mesh": False})))
    np.testing.assert_array_equal(x["global"], A0)
    np.testing.assert_array_equal(x["global"], np.asarray(J.to_global()))
    assert x["fallbacks"] == jfallbacks.counters() == {"redistribute": 1}


def test_redistribute_transposed_source(pool, rng, grid22):
    m, n = 37, 50
    M0 = rng.standard_normal((n, m))
    J = jaux.redistribute(jtranspose(st.Matrix.from_global(jnp.asarray(M0), 16, grid=grid22)),
                          st.Matrix.from_global(jnp.zeros((m, n)), 8, grid=grid22))
    x = _first(pool.run("redistribute", grid=G22, src=("Matrix", M0, 16, None, {"op": "Trans"}),
                        dst=("Matrix", np.zeros((m, n)), 8, None, {})))
    np.testing.assert_array_equal(x["global"], M0.T)
    np.testing.assert_array_equal(x["global"], np.asarray(J.to_global()))
    assert x["fallbacks"] == jfallbacks.counters() == {"redistribute": 1}


def test_redistribute_spmd_no_fallback(pool, rng, grid22):
    """Same-mesh redistribute takes the SPMD two-phase re-send: no
    recorded gather, even under RequireSpmd."""
    shape = (70, 52)
    A0 = rng.standard_normal(shape)
    J = jaux.redistribute(st.Matrix.from_global(jnp.asarray(A0), 16, grid=grid22),
                          st.Matrix.from_global(jnp.zeros(shape), 8, grid=grid22),
                          opts={st.Option.RequireSpmd: True})
    x = _first(pool.run("redistribute", grid=G22, src=("Matrix", A0, 16, None, {}),
                        dst=("Matrix", np.zeros(shape), 8, None, {}),
                        opts={"RequireSpmd": True}))
    np.testing.assert_array_equal(x["global"], A0)
    np.testing.assert_array_equal(x["global"], np.asarray(J.to_global()))
    assert x["fallbacks"] == jfallbacks.counters() == {}


def test_print_matrix(pool, rng, grid22):
    """print_matrix on the mesh: the root's text is the JAX package's;
    the other ranks return an empty string."""
    A0 = rng.standard_normal((8, 8))
    J = jaux.print_matrix("A", st.Matrix.from_global(jnp.asarray(A0), 4, grid=grid22))
    res = pool.run("print", grid=G22, spec=("Matrix", A0, 4, None, {}))
    assert res[0] == J and "A = [" in J and "8x8" in J and "grid 2x2" in J
    assert res[1:] == ["", "", ""]
    assert _first(pool.run("print", grid=G22, spec=("Matrix", A0, 4, None, {}),
                           verbose=1)).startswith("% A")


def test_hemm_dimension_mismatch_raises(pool, rng, grid22):
    A0 = rng.standard_normal((33, 33))
    A0 = (A0 + A0.T) / 2
    B0 = rng.standard_normal((40, 4))
    with pytest.raises(st.DimensionError) as e:
        jblas3.hemm(st.Side.Left, 1.0,
                    st.HermitianMatrix.from_global(jnp.asarray(A0), 16, grid=grid22,
                                                   uplo=st.Uplo.Lower),
                    st.Matrix.from_global(jnp.asarray(B0), 16, grid=grid22), 0.0,
                    st.Matrix.from_global(jnp.zeros((33, 4)), 16, grid=grid22))
    got = pool.run("raises", grid=G22, routine="blas3.hemm",
                   args=["Left", 1.0, ("HermitianMatrix", A0, 16, None, {"uplo": "Lower"}),
                         ("Matrix", B0, 16, None, {}), 0.0,
                         ("Matrix", np.zeros((33, 4)), 16, None, {})])
    assert [x["type"] for x in got] == ["DimensionError"] * 4
    assert got[0]["text"] == str(e.value)
