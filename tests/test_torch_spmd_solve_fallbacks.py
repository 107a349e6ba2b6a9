"""Port parity: the gather-fallback accounting of trsm, the
factorizations and the solves on a mesh (``internal/fallbacks.py``), on
gloo ranks against the JAX package's 2 x 2 virtual mesh and numpy.

The item-8b cases of ``tests/test_fallbacks.py`` (trsm with a viewed B
and on the right side, the three CALU cases, the lower potrf that
gathers nothing, getrs with a B that does not conform), plus the
records of an Upper potrf, of ``Option.UseShardMap`` off (potrf, getrf,
trsm, getrs; geqrf keeps its SPMD path and records nothing), of a getrf
with non-square tiles, and the refusals of the drivers whose mesh paths
are item 8b2.  The same seeded numpy operands go to the JAX package and
to a pool of 8 gloo ranks (``torch_mesh_pool``).
Tolerances: ``fallbacks.counters()`` equal to the JAX package's, route
by route, on every rank; a ``RequireSpmd`` call that falls back raises
the JAX package's text; results held to numpy by the reference tester's
residuals (3 eps; the CALU parity case keeps the JAX suite's factor 60
and its 30 x partial pivoting's backward error)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.drivers import blas3 as jblas3
from slate_tpu.drivers import chol as jchol
from slate_tpu.drivers import lu as jlu
from slate_tpu.drivers import qr as jqr
from slate_tpu.internal import fallbacks as jfallbacks
from slate_tpu.matrix.base import transpose as jtranspose
from slate_tpu.testing import checks
from torch_mesh_pool import MeshPool

torch.set_num_threads(1)

G22 = (2, 2, "Col", 4)
REQ = {"RequireSpmd": True}
JREQ = {st.Option.RequireSpmd: True}


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


def _spec(kind, a, mb, nb=None, **kw):
    return (kind, a, mb, nb, kw)


def _jmat(kind, a, mb, grid, nb=None, **kw):
    kw = {k: getattr(st, k.capitalize())[v] for k, v in kw.items()}
    return getattr(st, kind).from_global(jnp.asarray(a), mb, nb, grid=grid, **kw)


def _run(pool, routine, args, **kw):
    """Rank 0's answer; every rank of the grid tallies the same."""
    on = [r for r in pool.run("driver", grid=G22, routine=routine, args=args, **kw)
          if r is not None]
    assert len(on) == 4 and all(r["fallbacks"] == on[0]["fallbacks"] for r in on)
    return on[0]


def _raises_like_jax(pool, routine, args, opts, jax_call):
    """Every rank raises DistributedException with the JAX package's text."""
    got = [r for r in pool.run("raises", grid=G22, routine=routine, args=args, opts=opts)
           if r is not None]
    with pytest.raises(st.DistributedException) as e:
        jax_call()
    assert [r["type"] for r in got] == ["DistributedException"] * 4
    assert {r["text"] for r in got} == {str(e.value)}


def _tri(rng, n):
    return np.tril(rng.standard_normal((n, n))) + n * np.eye(n)


def _eps_ok(err, factor=3.0):
    assert checks.passed(err, np.float64, factor), err / checks.eps_of(np.float64)


def test_trsm_viewed_b_records_and_raises(pool, rng, grid22):
    """A transposed B view is not SPMD-conformable: falls back, records."""
    n, nb = 32, 16
    L0, Bt0 = _tri(rng, n), rng.standard_normal((4, n))
    J = jblas3.trsm(st.Side.Left, 1.0, _jmat("TriangularMatrix", L0, nb, grid22, uplo="Lower"),
                    jtranspose(_jmat("Matrix", Bt0, nb, grid22)))
    args = ["Left", 1.0, _spec("TriangularMatrix", L0, nb, uplo="Lower"),
            _spec("Matrix", Bt0, nb, op="Trans")]
    R = _run(pool, "blas3.trsm", args)
    assert R["fallbacks"] == jfallbacks.counters() == {"trsm": 1}
    np.testing.assert_allclose(R["out"]["global"], np.linalg.solve(L0, Bt0.T), atol=1e-12)
    np.testing.assert_allclose(R["out"]["global"], np.asarray(J.to_global()), atol=1e-12)
    _raises_like_jax(pool, "blas3.trsm", args, REQ, lambda: jblas3.trsm(
        st.Side.Left, 1.0, _jmat("TriangularMatrix", L0, nb, grid22, uplo="Lower"),
        jtranspose(_jmat("Matrix", Bt0, nb, grid22)), opts=JREQ))


def test_trsm_right_side_spmd(pool, rng, grid22):
    """Right-side solves ride the SPMD column pipeline: no fallback."""
    n, nb = 50, 16
    L0, B0 = _tri(rng, n), rng.standard_normal((8, n))
    jblas3.trsm(st.Side.Right, 1.0, _jmat("TriangularMatrix", L0, nb, grid22, uplo="Lower"),
                _jmat("Matrix", B0, nb, grid22), opts=JREQ)
    R = _run(pool, "blas3.trsm", ["Right", 1.0, _spec("TriangularMatrix", L0, nb, uplo="Lower"),
                                  _spec("Matrix", B0, nb)], opts=REQ)
    assert R["fallbacks"] == jfallbacks.counters() == {}
    np.testing.assert_allclose(R["out"]["global"], np.linalg.solve(L0.T, B0.T).T, atol=1e-11)


def test_calu_distributed_spmd_no_warning(pool, rng):
    """Distributed CALU rides the mesh tournament: no warning, no
    fallback, a LAPACK-grade factor."""
    n, nb = 64, 16
    A0 = rng.standard_normal((n, n)) + n * np.eye(n)
    R = _run(pool, "lu.getrf", [_spec("Matrix", A0, nb)],
             opts={"MethodLU": "CALU", "RequireSpmd": True})
    assert R["warnings"] == [] and R["fallbacks"] == {}
    LU, piv, info = R["out"]
    assert int(info) == 0
    G, perm = LU["global"], piv["perm"][:n]
    res = np.abs((np.tril(G, -1) + np.eye(n)) @ np.triu(G) - A0[perm]).max() / np.abs(A0).max()
    assert res < 1e-12, res


def test_calu_distributed_warns_on_fallback(pool, rng, grid22):
    """UseShardMap off: distributed CALU gathers, warns and records;
    string option keys canonicalize; under RequireSpmd it raises."""
    n, nb = 64, 16
    A0 = rng.standard_normal((n, n)) + n * np.eye(n)
    with pytest.warns(UserWarning, match="gathers"):
        jlu.getrf(_jmat("Matrix", A0, nb, grid22), {"method_lu": "calu", "useshardmap": False})
    R = _run(pool, "lu.getrf", [_spec("Matrix", A0, nb)],
             opts={"method_lu": "calu", "useshardmap": False})
    assert R["fallbacks"] == jfallbacks.counters() == {"getrf_tntpiv": 1}
    assert len(R["warnings"]) == 1 and "gathers" in R["warnings"][0]
    _eps_ok(checks.factor_residual(
        A0[R["out"][1]["perm"][:n]], np.tril(R["out"][0]["global"], -1) + np.eye(n),
        np.triu(R["out"][0]["global"])))
    opts = {"MethodLU": "CALU", "UseShardMap": False, "RequireSpmd": True}
    jopts = {st.Option.MethodLU: st.MethodLU.CALU, st.Option.UseShardMap: False, **JREQ}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _raises_like_jax(pool, "lu.getrf", [_spec("Matrix", A0, nb)], opts,
                         lambda: jlu.getrf(_jmat("Matrix", A0, nb, grid22), jopts))


@pytest.mark.parametrize("kind", ["svd_geo", "svd_arith"])
def test_calu_distributed_illconditioned_parity(pool, rng, kind):
    """Mesh-tournament CALU matches partial pivoting's solve quality on
    ill-conditioned matgen kinds (reference: test_gesv.cc tntpiv runs)."""
    from slate_tpu.matgen.generate import generate_2d

    n, nb = 96, 16
    A0 = np.asarray(generate_2d(kind, n, n, cond=1e8, seed=11)[0])
    B0 = rng.standard_normal((n, 3))
    args = [_spec("Matrix", A0, nb), _spec("Matrix", B0, nb)]
    Xc = _run(pool, "lu.gesv", args, opts={"MethodLU": "CALU"})["out"][0]["global"]
    Xp = _run(pool, "lu.gesv", args)["out"][0]["global"]
    ec = checks.solve_residual(A0, Xc, B0)
    ep = checks.solve_residual(A0, Xp, B0)
    assert checks.passed(ec, np.float64, factor=60), (ec, ep)
    assert ec <= 30 * max(ep, np.finfo(np.float64).eps), (ec, ep)


def test_potrf_lower_no_gather(pool, rng, grid22):
    """Distributed lower potrf reads only the stored tiles: no to_global
    or full_global call, no record, even under RequireSpmd."""
    n, nb = 64, 16
    A0 = rng.standard_normal((n, n))
    A0 = A0 @ A0.T + n * np.eye(n)
    jchol.potrf(_jmat("HermitianMatrix", A0, nb, grid22, uplo="Lower"), JREQ)
    R = _run(pool, "chol.potrf", [_spec("HermitianMatrix", A0, nb, uplo="Lower")], opts=REQ,
             patch=(("BaseMatrix", "to_global"), ("HermitianMatrix", "full_global")))
    assert R["fallbacks"] == jfallbacks.counters() == {}
    _eps_ok(checks.factor_residual(A0, np.tril(R["out"][0]["global"])))


def test_getrs_fallback_records(pool, rng, grid22):
    """A B with other tiles than the factor's falls back and records."""
    n, nb = 64, 16
    A0 = rng.standard_normal((n, n)) + n * np.eye(n)
    B0 = rng.standard_normal((n, 4))
    jX = jlu.gesv(_jmat("Matrix", A0, nb, grid22), _jmat("Matrix", B0, 32, grid22))[0]
    args = [_spec("Matrix", A0, nb), _spec("Matrix", B0, 32)]
    R = _run(pool, "lu.gesv", args)
    assert R["fallbacks"] == jfallbacks.counters() == {"getrs": 1}
    _eps_ok(checks.solve_residual(A0, R["out"][0]["global"], B0))
    np.testing.assert_allclose(R["out"][0]["global"], np.asarray(jX.to_global()), atol=1e-13)
    _raises_like_jax(pool, "lu.gesv", args, REQ, lambda: jlu.gesv(
        _jmat("Matrix", A0, nb, grid22), _jmat("Matrix", B0, 32, grid22), opts=JREQ))


@pytest.mark.parametrize("routine,kind,records", [
    ("chol.potrf", "HermitianMatrix", {"potrf": 1}),
    ("lu.getrf", "Matrix", {"getrf": 1}),
    ("qr.geqrf", "Matrix", {}),
])
def test_use_shard_map_off_gathers(pool, rng, grid22, routine, kind, records):
    """Option.UseShardMap off: potrf and getrf take the gathered global
    path, recorded as in the JAX package; geqrf keeps its SPMD path and
    records nothing (the JAX package gathers there without a record);
    every rank keeps its block of the same result."""
    n, nb = 48, 16
    A0 = rng.standard_normal((n, n))
    A0 = A0 @ A0.T + n * np.eye(n)
    jfn = {"chol.potrf": jchol.potrf, "lu.getrf": jlu.getrf, "qr.geqrf": jqr.geqrf}[routine]
    jkw = {"uplo": "Lower"} if kind == "HermitianMatrix" else {}
    jout = jfn(_jmat(kind, A0, nb, grid22, **jkw), {st.Option.UseShardMap: False})
    R = _run(pool, routine, [_spec(kind, A0, nb, **jkw)], opts={"UseShardMap": False})
    assert R["fallbacks"] == jfallbacks.counters() == records
    got, want = R["out"][0]["global"], np.asarray(jout[0].to_global())
    if routine == "chol.potrf":
        got, want = np.tril(got), np.tril(want)
    assert R["out"][0]["local_shape"] == (2, 2, nb, nb)
    np.testing.assert_allclose(got, want, atol=1e-12 * n)


def test_trsm_and_getrs_use_shard_map_off_record(pool, rng, grid22):
    """With UseShardMap off trsm records ``trsm`` and a gesv records
    ``getrf`` and ``getrs``, as the JAX package's routes do."""
    n, nb = 48, 16
    L0, A0, B0 = _tri(rng, n), rng.standard_normal((n, n)) + n * np.eye(n), \
        rng.standard_normal((n, 3))
    off = {st.Option.UseShardMap: False}
    jblas3.trsm(st.Side.Left, 1.0, _jmat("TriangularMatrix", L0, nb, grid22, uplo="Lower"),
                _jmat("Matrix", B0, nb, grid22), opts=off)
    jlu.gesv(_jmat("Matrix", A0, nb, grid22), _jmat("Matrix", B0, nb, grid22), off)
    J = jfallbacks.counters()
    R1 = _run(pool, "blas3.trsm", ["Left", 1.0, _spec("TriangularMatrix", L0, nb, uplo="Lower"),
                                   _spec("Matrix", B0, nb)], opts={"UseShardMap": False})
    R2 = _run(pool, "lu.gesv", [_spec("Matrix", A0, nb), _spec("Matrix", B0, nb)],
              opts={"UseShardMap": False})
    assert {**R1["fallbacks"], **R2["fallbacks"]} == J == {"trsm": 1, "getrf": 1, "getrs": 1}
    np.testing.assert_allclose(R1["out"]["global"], np.linalg.solve(L0, B0), atol=1e-13)
    _eps_ok(checks.solve_residual(A0, R2["out"][0]["global"], B0))


def test_getrf_non_square_tiles_records(pool, rng, grid22):
    """Tiles of 16 x 8 take the gathered LU, recorded ``getrf``; the pivots
    are the JAX package's."""
    n = 48
    A0 = rng.standard_normal((n, n))
    jLU, jpiv, _ = jlu.getrf(_jmat("Matrix", A0, 16, grid22, nb=8))
    R = _run(pool, "lu.getrf", [_spec("Matrix", A0, 16, 8)])
    assert R["fallbacks"] == jfallbacks.counters() == {"getrf": 1}
    LU, piv, info = R["out"]
    assert int(info) == 0
    _eps_ok(checks.factor_residual(A0[piv["perm"][:n]], np.tril(LU["global"], -1) + np.eye(n),
                                   np.triu(LU["global"])))
    np.testing.assert_array_equal(piv["perm"][:n], np.asarray(jpiv.perm)[:n])


@pytest.mark.parametrize("method,shape", [("CholQR", (64, 32)), ("Auto", (32, 64))])
def test_gels_branches_of_item_8b2_raise(pool, rng, method, shape):
    """gels's CholQR branch (cholqr) and its minimum-norm branch (gelqf)
    refuse a distributed operand, naming ROADMAP.md Queue 1 item 8b2; the
    tall QR branch is tests/test_torch_spmd_factor.py's."""
    A0 = rng.standard_normal(shape)
    got = [r for r in pool.run("raises", grid=G22, routine="qr.gels",
                               args=[_spec("Matrix", A0, 16), _spec("Matrix", A0[:, :2], 16)],
                               opts={"MethodGels": method}) if r is not None]
    assert [r["type"] for r in got] == ["DistributedException"] * 4
    assert all("Queue 1 item 8b2" in r["text"] for r in got)
