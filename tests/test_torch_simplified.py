"""Port parity: the verb API (``simplified``) and the tile distribution
functions (``func``) of slate_tpu_torch against the JAX package on the
CPU.

Each verb gives the same result as the driver it dispatches to (bit for
bit: the same call) and the JAX package's verb within ``50 n eps
max|ref|``, as in tests/test_torch_blas.py; each distribution function
gives the JAX package's value at every (i, j) of a grid."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu import func as jfunc
from slate_tpu import simplified as jsimp
from slate_tpu_torch import func as tfunc
from slate_tpu_torch import simplified as tsimp

torch.set_num_threads(1)

CPU = stt.ProcessGrid.single("cpu")
N, NB = 40, 16


def _tol(n, ref):
    return 50 * n * np.finfo(np.float64).eps * max(float(np.abs(ref).max()), 1.0)


def _np(x):
    """A result as numpy: a matrix's global array, a tensor, or a tuple
    of either (pivots by their permutation, triangular factors by T)."""
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    if isinstance(x, (st.Pivots, stt.Pivots)):
        return _np(x.perm)
    if isinstance(x, (st.TriangularFactors, stt.TriangularFactors)):
        return _np(x.T)
    if hasattr(x, "to_global"):
        x = x.to_global()
    if torch.is_tensor(x):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _same(a, b):
    for x, y in zip(_np(a) if isinstance(a, tuple) else (_np(a),),
                    _np(b) if isinstance(b, tuple) else (_np(b),)):
        np.testing.assert_array_equal(x, y)


def _close(got, ref):
    for x, y in zip(_np(got) if isinstance(got, tuple) else (_np(got),),
                    _np(ref) if isinstance(ref, tuple) else (_np(ref),)):
        if np.issubdtype(np.asarray(y).dtype, np.integer):
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, rtol=0, atol=_tol(N, y))


def _operands(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((N, N))
    return {"gen": a, "spd": a @ a.T + N * np.eye(N), "b": rng.standard_normal((N, 6)),
            "c": rng.standard_normal((N, 6)), "tall": rng.standard_normal((2 * N, N)),
            "tri": np.tril(a) + N * np.eye(N), "k": rng.standard_normal((N, 8)),
            "k2": rng.standard_normal((N, 8)), "wide": rng.standard_normal((N, 2 * N))}


def _both(pkg, grid, d, name, kind="Matrix", **kw):
    cls = getattr(pkg, kind)
    x = jnp.asarray(d[name]) if pkg is st else d[name]
    kw = {k: getattr(pkg, type(v).__name__)[v.name] for k, v in kw.items()}
    return cls.from_global(x, NB, grid=grid, **kw)


def _case(pkg, grid, d, verb):
    """(verb call, driver call) of one verb in one package."""
    M = lambda name, kind="Matrix", **kw: _both(pkg, grid, d, name, kind, **kw)  # noqa: E731
    simp = jsimp if pkg is st else tsimp
    if verb == "multiply":
        return (lambda: simp.multiply(2.0, M("gen"), M("b"), 0.5, M("c")),
                lambda: pkg.gemm(2.0, M("gen"), M("b"), 0.5, M("c")))
    if verb == "multiply_hemm_left":
        A = M("spd", "HermitianMatrix")
        return (lambda: simp.multiply(2.0, A, M("b"), 0.5, M("c")),
                lambda: pkg.hemm(pkg.Side.Left, 2.0, A, M("b"), 0.5, M("c")))
    if verb == "multiply_hemm_right":
        A = M("spd", "HermitianMatrix")
        Bt, Ct = pkg.transpose(M("b")), pkg.transpose(M("c"))
        return (lambda: simp.multiply(2.0, Bt, A, 0.5, Ct),
                lambda: pkg.hemm(pkg.Side.Right, 2.0, A, Bt, 0.5, Ct))
    if verb == "multiply_symm_left":
        A = M("spd", "SymmetricMatrix", uplo=stt.Uplo.Upper)
        return (lambda: simp.multiply(2.0, A, M("b"), 0.5, M("c")),
                lambda: pkg.symm(pkg.Side.Left, 2.0, A, M("b"), 0.5, M("c")))
    if verb == "multiply_symm_right":
        A = M("spd", "SymmetricMatrix")
        Bt, Ct = pkg.transpose(M("b")), pkg.transpose(M("c"))
        return (lambda: simp.multiply(2.0, Bt, A, 0.5, Ct),
                lambda: pkg.symm(pkg.Side.Right, 2.0, A, Bt, 0.5, Ct))
    if verb == "rank_k_update":
        return (lambda: simp.rank_k_update(1.0, M("k"), 0.5, M("spd", "HermitianMatrix")),
                lambda: pkg.herk(1.0, M("k"), 0.5, M("spd", "HermitianMatrix")))
    if verb == "rank_k_update_sym":
        return (lambda: simp.rank_k_update(1.0, M("k"), 0.5, M("spd", "SymmetricMatrix")),
                lambda: pkg.syrk(1.0, M("k"), 0.5, M("spd", "SymmetricMatrix")))
    if verb == "rank_2k_update":
        return (lambda: simp.rank_2k_update(1.0, M("k"), M("k2"), 0.5,
                                            M("spd", "HermitianMatrix")),
                lambda: pkg.her2k(1.0, M("k"), M("k2"), 0.5, M("spd", "HermitianMatrix")))
    if verb == "rank_2k_update_sym":
        return (lambda: simp.rank_2k_update(1.0, M("k"), M("k2"), 0.5,
                                            M("spd", "SymmetricMatrix")),
                lambda: pkg.syr2k(1.0, M("k"), M("k2"), 0.5, M("spd", "SymmetricMatrix")))
    if verb == "triangular_multiply":
        T = M("tri", "TriangularMatrix")
        Bt = pkg.transpose(M("b"))
        return (lambda: simp.triangular_multiply(2.0, T, Bt, pkg.Side.Right),
                lambda: pkg.trmm(pkg.Side.Right, 2.0, T, Bt))
    if verb == "triangular_solve":
        T = M("tri", "TriangularMatrix")
        return (lambda: simp.triangular_solve(2.0, T, M("b")),
                lambda: pkg.trsm(pkg.Side.Left, 2.0, T, M("b")))
    if verb == "lu_factor":
        return lambda: simp.lu_factor(M("gen")), lambda: pkg.getrf(M("gen"))
    if verb == "lu_factor_nopiv":
        return lambda: simp.lu_factor_nopiv(M("spd")), lambda: pkg.getrf_nopiv(M("spd"))
    if verb == "lu_solve":
        opts = {"method_lu": "calu"}
        return (lambda: simp.lu_solve(M("gen"), M("b"), opts),
                lambda: pkg.gesv(M("gen"), M("b"), opts)[0])
    if verb in ("lu_solve_using_factor", "lu_inverse_using_factor",
                "lu_inverse_using_factor_out_of_place"):
        LU, piv, _ = pkg.getrf(M("gen"))
        if verb == "lu_solve_using_factor":
            return (lambda: simp.lu_solve_using_factor(LU, piv, M("b")),
                    lambda: pkg.getrs(LU, piv, M("b")))
        return (lambda: getattr(simp, verb)(LU, piv), lambda: pkg.getri(LU, piv))
    if verb == "lu_solve_using_factor_nopiv":
        LU, _ = pkg.getrf_nopiv(M("spd"))
        return (lambda: simp.lu_solve_using_factor_nopiv(LU, M("b")),
                lambda: pkg.getrs_nopiv(LU, M("b")))
    if verb == "chol_factor":
        return (lambda: simp.chol_factor(M("spd", "HermitianMatrix")),
                lambda: pkg.potrf(M("spd", "HermitianMatrix")))
    if verb == "chol_solve":
        return (lambda: simp.chol_solve(M("spd", "HermitianMatrix"), M("b")),
                lambda: pkg.posv(M("spd", "HermitianMatrix"), M("b"))[0])
    if verb in ("chol_solve_using_factor", "chol_inverse_using_factor"):
        L, _ = pkg.potrf(M("spd", "HermitianMatrix"))
        if verb == "chol_solve_using_factor":
            return (lambda: simp.chol_solve_using_factor(L, M("b")),
                    lambda: pkg.potrs(L, M("b")))
        return (lambda: simp.chol_inverse_using_factor(L), lambda: pkg.potri(L))
    if verb == "least_squares_solve":
        tall_b = M("tall")
        return (lambda: simp.least_squares_solve(M("tall"), tall_b),
                lambda: pkg.gels(M("tall"), tall_b))
    if verb == "qr_factor":
        return lambda: simp.qr_factor(M("tall")), lambda: pkg.geqrf(M("tall"))
    if verb == "lq_factor":
        return lambda: simp.lq_factor(M("wide")), lambda: pkg.gelqf(M("wide"))
    if verb in ("multiply_by_q", "multiply_by_q_lq"):
        lq = verb.endswith("lq")
        fac, T = pkg.gelqf(M("wide")) if lq else pkg.geqrf(M("tall"))
        C = M("tall")
        fn = pkg.unmlq if lq else pkg.unmqr
        return (lambda: simp.multiply_by_q(pkg.Side.Left, pkg.Op.ConjTrans, fac, T, C,
                                           from_lq=lq),
                lambda: fn(pkg.Side.Left, pkg.Op.ConjTrans, fac, T, C))
    raise AssertionError(verb)


VERBS = ["multiply", "multiply_hemm_left", "multiply_hemm_right", "multiply_symm_left",
         "multiply_symm_right", "rank_k_update", "rank_k_update_sym", "rank_2k_update",
         "rank_2k_update_sym", "triangular_multiply", "triangular_solve", "lu_factor",
         "lu_factor_nopiv", "lu_solve", "lu_solve_using_factor",
         "lu_solve_using_factor_nopiv", "lu_inverse_using_factor",
         "lu_inverse_using_factor_out_of_place", "chol_factor", "chol_solve",
         "chol_solve_using_factor", "chol_inverse_using_factor", "least_squares_solve",
         "qr_factor", "lq_factor", "multiply_by_q", "multiply_by_q_lq"]


@pytest.mark.parametrize("verb", VERBS)
def test_verb_is_its_driver_and_matches_jax(verb, grid11):
    d = _operands(len(verb))
    tverb, tdriver = _case(stt, CPU, d, verb)
    jverb, _ = _case(st, grid11, d, verb)
    got = tverb()
    _same(got, tdriver())
    _close(got, jverb())


def test_verbs_cover_the_landed_slices():
    """Every verb of the JAX package is here (the band, indefinite,
    eigenvalue and SVD verbs landed with their slices)."""
    def verbs(mod):
        return {n for n in dir(mod) if not n.startswith("_") and callable(getattr(mod, n))
                and getattr(getattr(mod, n), "__module__", "") == mod.__name__}

    assert verbs(tsimp) == verbs(jsimp)


# ---------------------------------------------------------------------------
# func
# ---------------------------------------------------------------------------

IJ = list(itertools.product(range(7), range(6)))


def _same_map(jf, tf):
    assert [tf(ij) for ij in IJ] == [jf(ij) for ij in IJ]


@pytest.mark.parametrize("order", ["Col", "Row"])
def test_func_grids_match_jax(order):
    jo, to = st.GridOrder[order], stt.GridOrder[order]
    for m, n, p, q in [(1, 1, 2, 3), (2, 3, 3, 2), (4, 1, 1, 4)]:
        _same_map(jfunc.device_2d_grid(jo, m, n, p, q), tfunc.device_2d_grid(to, m, n, p, q))
    for bs, size in [(1, 4), (3, 2)]:
        _same_map(jfunc.device_1d_grid(jo, bs, size), tfunc.device_1d_grid(to, bs, size))
    _same_map(jfunc.process_2d_grid(jo, 2, 3), tfunc.process_2d_grid(to, 2, 3))
    _same_map(jfunc.process_1d_grid(jo, 5), tfunc.process_1d_grid(to, 5))
    _same_map(jfunc.transpose_grid(jfunc.process_2d_grid(jo, 2, 3)),
              tfunc.transpose_grid(tfunc.process_2d_grid(to, 2, 3)))
    with pytest.raises(stt.SlateError):
        tfunc.device_2d_grid(stt.GridOrder.Unknown, 1, 1, 2, 2)


def test_func_sizes_and_round_robin_match_jax():
    for n, nb in [(10, 3), (12, 4), (5, 8), (0, 4)]:
        js, ts = jfunc.uniform_blocksize(n, nb), tfunc.uniform_blocksize(n, nb)
        assert [ts(j) for j in range(6)] == [js(j) for j in range(6)]
        nt = -(-n // nb)
        assert tfunc.max_blocksize(nt, ts) == jfunc.max_blocksize(nt, js)
    _same_map(jfunc.round_robin(5), tfunc.round_robin(5))


@pytest.mark.parametrize("mt,nt", [(0, 3), (1, 1), (6, 4), (5, 5), (4, 1)])
def test_is_2d_cyclic_grid_matches_jax(mt, nt):
    cands = [(lambda ij: 0), (lambda ij: (ij[0] + ij[1]) % 3)]
    for order, p, q in itertools.product(["Col", "Row"], [1, 2, 3], [1, 2]):
        cands.append(tfunc.process_2d_grid(stt.GridOrder[order], p, q))
        cands.append(tfunc.device_2d_grid(stt.GridOrder[order], 2, 1, p, q))
    for f in cands:
        jr, tr = jfunc.is_2d_cyclic_grid(mt, nt, f), tfunc.is_2d_cyclic_grid(mt, nt, f)
        assert (tr[0], tr[1].name, tr[2], tr[3]) == (jr[0], jr[1].name, jr[2], jr[3])
