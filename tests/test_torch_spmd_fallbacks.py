"""Port parity: trmm, herk / syrk and her2k / syr2k on a mesh
(``parallel/spmd_blas.py``) and the gather-fallback accounting
(``internal/fallbacks.py``), on gloo ranks against the JAX package and
numpy.

The item-8a cases of ``tests/test_fallbacks.py`` (trmm, herk, her2k,
counters_reset) and the herk / her2k mesh cases of
``tests/test_blas3.py``, with their parameters.  The JAX package's mesh
herk takes 15-30 s a call to trace on the CPU (its suite marks those
cases slow), so the herk / her2k cases that do not fall back hold the
port's mesh result against the JAX package's single-device result
(``grid11``) and numpy, and their fallback tally to the ``{}`` the JAX
suite asserts; the fallback cases run the JAX package on its mesh.  The
same seeded numpy operands go to the JAX package and to a pool of 8 gloo
ranks (``torch_mesh_pool``), where each rank builds its blocks, runs the
driver and gathers the result.
Tolerances: float64 within 1e-12 of the elementwise scale (|alpha| |A|
|B| + |beta| |C| and the like) against both; ``fallbacks.counters()``
equal to the JAX package's, route by route; a ``RequireSpmd`` call that
falls back raises in both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.drivers import blas3 as jblas3
from slate_tpu.internal import fallbacks as jfallbacks
from slate_tpu.matrix.base import conj_transpose as jconj_transpose
from slate_tpu_torch.internal import fallbacks as tfallbacks
from torch_mesh_pool import MeshPool

torch.set_num_threads(1)

G22, G42 = (2, 2, "Col", 4), (4, 2, "Col", 8)
REQ = {"RequireSpmd": True}


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


def _herm(rng, n, cplx=False):
    a = _mk(rng, n, n, cplx)
    return (a + a.conj().T) / 2


def test_herk_distributed_spmd(pool, rng, grid11):
    n, k, nb = 64, 48, 16
    A0, C0 = _mk(rng, n, k), _herm(rng, n)
    J = jblas3.herk(1.0, _jmat("Matrix", A0, nb, grid11), 0.5,
                    _jmat("HermitianMatrix", C0, nb, grid11, uplo="Lower"))
    T = _on_rank0(pool, G22, "herk", [1.0, _spec("Matrix", A0, nb), 0.5,
                                      _spec("HermitianMatrix", C0, nb, uplo="Lower")], full=True)
    _hold(T["global"], J.full_global(), A0 @ A0.T + 0.5 * C0,
          np.abs(A0) @ np.abs(A0).T + 0.5 * np.abs(C0))
    assert T["fallbacks"] == {}


def test_her2k_distributed_complex(pool, rng, grid11):
    n, k, nb = 48, 32, 16
    A0, B0, C0 = _mk(rng, n, k, True), _mk(rng, n, k, True), _herm(rng, n, True)
    alpha = 1.3 - 0.4j
    J = jblas3.her2k(alpha, _jmat("Matrix", A0, nb, grid11), _jmat("Matrix", B0, nb, grid11), 0.5,
                     _jmat("HermitianMatrix", C0, nb, grid11, uplo="Lower"))
    T = _on_rank0(pool, G22, "her2k", [alpha, _spec("Matrix", A0, nb), _spec("Matrix", B0, nb),
                                       0.5, _spec("HermitianMatrix", C0, nb, uplo="Lower")],
                  full=True)
    ref = alpha * A0 @ B0.conj().T + np.conj(alpha) * B0 @ A0.conj().T + 0.5 * C0
    scale = abs(alpha) * 2 * np.abs(A0) @ np.abs(B0).T + 0.5 * np.abs(C0)
    _hold(T["global"], J.full_global(), ref, scale)
    assert T["fallbacks"] == {}


# -- test_fallbacks.py, item 8a ---------------------------------------------


def _tri(rng, n):
    return np.tril(rng.standard_normal((n, n))) + n * np.eye(n)


def test_trmm_distributed_records_and_raises(pool, rng, grid22):
    """Non-conformable tiles (B mb != A nb) fall back and record; under
    RequireSpmd the call raises."""
    n, nb = 64, 16
    L0, B0 = _tri(rng, n), rng.standard_normal((n, 4))
    J = jblas3.trmm(st.Side.Left, 1.0, _jmat("TriangularMatrix", L0, nb, grid22, uplo="Lower"),
                    _jmat("Matrix", B0, 32, grid22))
    T = _on_rank0(pool, G22, "trmm", ["Left", 1.0, _spec("TriangularMatrix", L0, nb, uplo="Lower"),
                                      _spec("Matrix", B0, 32)])
    _hold(T["global"], J.to_global(), L0 @ B0, np.abs(L0) @ np.abs(B0))
    assert T["fallbacks"] == jfallbacks.counters() == {"trmm": 1}
    res = pool.run("raises", grid=G22, routine="blas3.trmm",
                   args=["Left", 1.0, _spec("TriangularMatrix", L0, nb, uplo="Lower"),
                         _spec("Matrix", B0, 32)], opts=REQ)
    with pytest.raises(st.DistributedException) as e:
        jblas3.trmm(st.Side.Left, 1.0, _jmat("TriangularMatrix", L0, nb, grid22, uplo="Lower"),
                    _jmat("Matrix", B0, 32, grid22), opts={st.Option.RequireSpmd: True})
    assert [r["type"] for r in res if r] == ["DistributedException"] * 4
    assert res[0]["text"] == str(e.value)


@pytest.mark.parametrize("side", ["Left", "Right"])
@pytest.mark.parametrize("op", ["NoTrans", "ConjTrans"])
def test_trmm_spmd(pool, rng, grid22, side, op):
    """Distributed trmm rides the triangular SUMMA: no fallback (the JAX
    case is Left / NoTrans; the other sides and views hold to numpy and
    the JAX package the same way)."""
    n, nb = 50, 16
    L0 = _tri(rng, n) + 1j * np.tril(rng.standard_normal((n, n)))
    B0 = _mk(rng, n, 8, True) if side == "Left" else _mk(rng, 8, n, True)
    view = {"op": op} if op != "NoTrans" else {}
    spec = _spec("TriangularMatrix", L0, nb, uplo="Lower", **view)
    JL = _jmat("TriangularMatrix", L0, nb, grid22, uplo="Lower")
    if op == "ConjTrans":
        JL = jconj_transpose(JL)
    J = jblas3.trmm(st.Side[side], 2.0, JL, _jmat("Matrix", B0, nb, grid22),
                    opts={st.Option.RequireSpmd: True})
    T = _on_rank0(pool, G22, "trmm", [side, 2.0, spec, _spec("Matrix", B0, nb)], opts=REQ)
    opL = L0 if op == "NoTrans" else L0.conj().T
    ref = 2.0 * (opL @ B0 if side == "Left" else B0 @ opL)
    scale = 2.0 * (np.abs(opL) @ np.abs(B0) if side == "Left" else np.abs(B0) @ np.abs(opL))
    _hold(T["global"], J.to_global(), ref, scale)
    assert T["fallbacks"] == jfallbacks.counters() == {}


def test_herk_mixed_op_records(pool, rng, grid22):
    """syrk of a conj-transposed view is a mixed op/conj combination: it
    falls back, records 'herk', and raises under RequireSpmd."""
    n, nb = 32, 16
    A0, C0 = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    C0 = C0 + C0.T
    J = jblas3.syrk(1.0, jconj_transpose(_jmat("Matrix", A0, nb, grid22)), 0.0,
                    _jmat("HermitianMatrix", C0, nb, grid22, uplo="Lower"))
    args = [1.0, _spec("Matrix", A0, nb, op="ConjTrans"), 0.0,
            _spec("HermitianMatrix", C0, nb, uplo="Lower")]
    T = _on_rank0(pool, G22, "syrk", args)
    np.testing.assert_allclose(np.tril(T["global"]), np.tril(np.asarray(J.to_global())),
                               rtol=0, atol=1e-12 * n)
    np.testing.assert_allclose(np.tril(T["global"]), np.tril(A0.T @ A0), rtol=0, atol=1e-12 * n)
    assert T["fallbacks"] == jfallbacks.counters() == {"herk": 1}
    res = pool.run("raises", grid=G22, routine="blas3.syrk", args=args, opts=REQ)
    assert [r["type"] for r in res if r] == ["DistributedException"] * 4


@pytest.mark.parametrize("case", ["transposed_grid_4x2", "trans_view_2x2"])
def test_herk_spmd_no_fallback(pool, rng, grid11, case):
    """herk on a non-square mesh does not fall back (a resolved A^H would
    live on the transposed grid); herk of A^H rides the row gathers."""
    n, nb = (64, 16) if case == "transposed_grid_4x2" else (48, 16)
    grid = G42 if case == "transposed_grid_4x2" else G22
    k = n if case == "transposed_grid_4x2" else 32
    A0 = rng.standard_normal((n, k) if case == "transposed_grid_4x2" else (k, n))
    C0 = rng.standard_normal((n, n))
    C0 = C0 + C0.T
    JA = _jmat("Matrix", A0, nb, grid11)
    spec = _spec("Matrix", A0, nb)
    opA = A0
    if case == "trans_view_2x2":
        JA, spec, opA = jconj_transpose(JA), _spec("Matrix", A0, nb, op="ConjTrans"), A0.T
    J = jblas3.herk(1.0, JA, 0.5, _jmat("HermitianMatrix", C0, nb, grid11, uplo="Lower"))
    T = _on_rank0(pool, grid, "herk", [1.0, spec, 0.5,
                                       _spec("HermitianMatrix", C0, nb, uplo="Lower")], opts=REQ)
    tri = np.tril_indices(n)
    _hold(T["global"][tri], np.asarray(J.to_global())[tri], (opA @ opA.T + 0.5 * C0)[tri],
          (np.abs(opA) @ np.abs(opA).T + 0.5 * np.abs(C0))[tri])
    assert T["fallbacks"] == {}


def test_her2k_spmd_no_fallback(pool, rng, grid11):
    n, k, nb = 48, 32, 16
    A0, B0 = rng.standard_normal((n, k)), rng.standard_normal((n, k))
    C0 = rng.standard_normal((n, n))
    C0 = C0 + C0.T
    J = jblas3.syr2k(1.0, _jmat("Matrix", A0, nb, grid11), _jmat("Matrix", B0, nb, grid11), 0.5,
                     _jmat("HermitianMatrix", C0, nb, grid11, uplo="Lower"))
    T = _on_rank0(pool, G22, "syr2k", [1.0, _spec("Matrix", A0, nb), _spec("Matrix", B0, nb), 0.5,
                                       _spec("HermitianMatrix", C0, nb, uplo="Lower")], opts=REQ)
    tri = np.tril_indices(n)
    _hold(T["global"][tri], np.asarray(J.to_global())[tri],
          (A0 @ B0.T + B0 @ A0.T + 0.5 * C0)[tri],
          (2 * np.abs(A0) @ np.abs(B0).T + 0.5 * np.abs(C0))[tri])
    assert T["fallbacks"] == {}


def test_counters_reset():
    for fb in (jfallbacks, tfallbacks):
        fb.record("x")
        assert fb.counters() == {"x": 1}
        fb.reset()
        assert fb.counters() == {}


@pytest.mark.parametrize("routine", ["gemm", "herk"])
def test_use_shard_map_off_keeps_the_spmd_route(pool, rng, grid11, routine):
    """The port has no GSPMD, so ``Option.UseShardMap`` False does not turn
    a distributed call into an unrecorded gather: gemm and herk still
    take the spmd kernels (no operand gathered, nothing recorded, and
    RequireSpmd does not raise), equal to the JAX package's result."""
    opts = {"UseShardMap": False, **REQ}
    jopts = {st.Option.UseShardMap: False, st.Option.RequireSpmd: True}
    no_gather = [("BaseMatrix", "to_global"), ("BaseMatrix", "storage"),
                 ("HermitianMatrix", "full_global")]
    n, k, nb = 48, 32, 16
    A0, C0 = _mk(rng, n, k), _herm(rng, n)
    if routine == "gemm":
        B0 = _mk(rng, k, n)
        J = jblas3.gemm(1.5, _jmat("Matrix", A0, nb, grid11), _jmat("Matrix", B0, nb, grid11),
                        0.5, _jmat("Matrix", C0, nb, grid11), opts=jopts)
        T = _on_rank0(pool, G22, "gemm", [1.5, _spec("Matrix", A0, nb), _spec("Matrix", B0, nb),
                                          0.5, _spec("Matrix", C0, nb)], opts=opts,
                      patch=no_gather)
        _hold(T["global"], J.to_global(), 1.5 * A0 @ B0 + 0.5 * C0,
              1.5 * np.abs(A0) @ np.abs(B0) + 0.5 * np.abs(C0))
    else:
        J = jblas3.herk(1.0, _jmat("Matrix", A0, nb, grid11), 0.5,
                        _jmat("HermitianMatrix", C0, nb, grid11, uplo="Lower"), opts=jopts)
        T = _on_rank0(pool, G22, "herk", [1.0, _spec("Matrix", A0, nb), 0.5,
                                          _spec("HermitianMatrix", C0, nb, uplo="Lower")],
                      opts=opts, full=True, patch=no_gather)
        _hold(T["global"], J.full_global(), A0 @ A0.T + 0.5 * C0,
              np.abs(A0) @ np.abs(A0).T + 0.5 * np.abs(C0))
    assert T["fallbacks"] == jfallbacks.counters() == {}
