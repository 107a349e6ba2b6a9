"""Port parity: the tile layer and the norm drivers of slate_tpu_torch
against the JAX package, on the CPU.

* the plain versions of ``tile_norms``, ``tile_geadd`` and
  ``tile_transpose`` against the JAX package's Pallas kernels in
  interpret mode;
* ``internal/tile_ops.py`` (masks, ge* and tz* ops, batch_transpose);
* ``internal/norms.py`` (genorm, trnorm, synorm, henorm) for every norm
  and scope, on a 2 x 2 logical grid so that the owner-major tile
  scatter is exercised;
* ``drivers/aux.py`` (add, copy, scale, scale_row_col, set, set_lambdas,
  norm, colNorms), on matrices carried across from the JAX package with
  ``matrix_from_reference``.

Tolerance: masks, copies, sets, max norms and transposes exactly equal;
sums and products within ``20 k eps max|ref|`` (k the length of the
sum), the rounding of sums taken in another order."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu.internal import norms as jn
from slate_tpu.internal import tile_ops as jt
from slate_tpu.ops.pallas import kernels as jk
from slate_tpu.parallel import layout as jl
from slate_tpu_torch.internal import norms as tn
from slate_tpu_torch.internal import tile_ops as tt
from slate_tpu_torch.ops.hopper import panel_kernels as pk
from slate_tpu_torch.parallel import layout as tl

torch.set_num_threads(1)

KINDS = ["max", "fro_sumsq", "one", "inf"]


def _close(got, ref, k=1, dtype=np.float64):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    tol = 20 * k * np.finfo(dtype).eps * max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def _rand(shape, seed, dtype=np.float64, complex_=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    if complex_:
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(np.complex128 if complex_ else dtype)


@pytest.fixture(autouse=True)
def _no_launches():
    pk.reset_launches()
    yield
    assert all(v == 0 for v in pk.LAUNCHES.values()), pk.LAUNCHES  # CPU: plain versions


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_tile_norms_plain_matches_jax_kernel(dtype, kind):
    T = np.abs(_rand((5, 16, 128), 1, dtype))
    ref = np.asarray(jk.tile_norms_pallas(jnp.asarray(T), kind, interpret=True))
    got = pk.tile_norms(torch.from_numpy(T), kind).numpy()  # the plain version on the CPU
    k = {"max": 1, "fro_sumsq": 16 * 128, "one": 16, "inf": 128}[kind]
    if kind == "max":
        np.testing.assert_array_equal(got, ref)
    else:
        _close(got, ref, k, dtype)
    np.testing.assert_array_equal(got, pk.tile_norms_plain(torch.from_numpy(T), kind).numpy())
    _close(got, np.asarray(jk.tile_norms_reference(jnp.asarray(T), kind)), k, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tile_geadd_and_transpose_plain_match_jax_kernels(dtype):
    A, B = _rand((3, 8, 16), 2, dtype), _rand((3, 8, 16), 3, dtype)
    ref = np.asarray(jk.tile_geadd_pallas(0.5, jnp.asarray(A), -2.0, jnp.asarray(B),
                                          interpret=True))
    got = pk.tile_geadd(0.5, torch.from_numpy(A), -2.0, torch.from_numpy(B)).numpy()
    _close(got, ref, 2, dtype)
    np.testing.assert_array_equal(
        got, pk.tile_geadd_plain(0.5, torch.from_numpy(A), -2.0, torch.from_numpy(B)).numpy())
    ref = np.asarray(jk.tile_transpose_pallas(jnp.asarray(A), interpret=True))
    np.testing.assert_array_equal(pk.tile_transpose(torch.from_numpy(A)).numpy(), ref)


def test_tile_transpose_plain_conjugates_complex():
    """Complex stacks against the JAX dispatcher's jnp path (interpret
    mode has no complex outputs)."""
    A = _rand((2, 4, 6), 4, complex_=True)
    ref = np.asarray(jk.tile_transpose(jnp.asarray(A), conj=True))
    np.testing.assert_array_equal(pk.tile_transpose_plain(torch.from_numpy(A), True).numpy(), ref)


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("complex_", [False, True])
def test_tile_transpose_wrapper_takes_conj(conj, complex_):
    """The wrapper's ``conj`` against the JAX package's Pallas kernel in
    interpret mode (real stacks) and its dispatcher's jnp path (complex
    stacks: interpret mode has no complex outputs)."""
    A = _rand((3, 5, 7), 6, complex_=complex_)
    if complex_:
        ref = np.asarray(jk.tile_transpose(jnp.asarray(A), conj=conj))
    else:
        ref = np.asarray(jk.tile_transpose_pallas(jnp.asarray(A), conj=conj, interpret=True))
    np.testing.assert_array_equal(pk.tile_transpose(torch.from_numpy(A), conj=conj).numpy(), ref)


def test_tile_kernels_reject_bad_arguments():
    with pytest.raises(ValueError):
        pk.tile_norms(torch.zeros(2, 3, 4), "two")
    with pytest.raises(ValueError):
        pk.tile_norms(torch.zeros(3, 4), "max")
    with pytest.raises(ValueError):
        pk.tile_geadd(1.0, torch.zeros(2, 3, 4), 1.0, torch.zeros(2, 4, 3))


# ---------------------------------------------------------------------------
# tile_ops
# ---------------------------------------------------------------------------

LAYOUT = dict(m=37, n=29, mb=8, nb=8, p=2, q=2)


def _layouts():
    return jl.TileLayout(**LAYOUT), tl.TileLayout(**LAYOUT)


def _tiles(a):
    jlay, tlay = _layouts()
    return (jl.tiles_from_global(jnp.asarray(a), jlay),
            tl.tiles_from_global(torch.from_numpy(a), tlay))


def test_tile_masks_match_jax():
    jlay, tlay = _layouts()
    for uplo, diag in itertools.product(["Lower", "Upper", "General"], ["NonUnit", "Unit"]):
        for valid in (True, False):
            ref = jt.tri_mask(jlay, st.Uplo[uplo], st.Diag[diag], valid)
            got = tt.tri_mask(tlay, stt.Uplo[uplo], stt.Diag[diag], valid)
            np.testing.assert_array_equal(np.broadcast_to(got.numpy(), jlay.storage_shape),
                                          np.broadcast_to(np.asarray(ref), jlay.storage_shape))
    np.testing.assert_array_equal(tt.diag_mask(tlay).numpy(), np.asarray(jt.diag_mask(jlay)))


def test_tile_ops_match_jax():
    jlay, tlay = _layouts()
    jA, tA = _tiles(_rand((37, 29), 5))
    jB, tB = _tiles(_rand((37, 29), 6))
    _close(tt.geadd(0.3, tA, -1.2, tB).numpy(), jt.geadd(0.3, jA, -1.2, jB), 2)
    np.testing.assert_array_equal(tt.gecopy(tA, torch.float32).numpy(),
                                  np.asarray(jt.gecopy(jA, jnp.float32)))
    _close(tt.gescale(3.0, 4.0, tA).numpy(), jt.gescale(3.0, 4.0, jA))
    R, C = _rand((40,), 7), _rand((31,), 8)
    _close(tt.gescale_row_col(tlay, torch.from_numpy(R), torch.from_numpy(C), tA).numpy(),
           jt.gescale_row_col(jlay, jnp.asarray(R), jnp.asarray(C), jA), 2)
    _close(tt.gescale_row_col(tlay, None, torch.from_numpy(C), tA).numpy(),
           jt.gescale_row_col(jlay, None, jnp.asarray(C), jA))
    np.testing.assert_array_equal(tt.geset(tlay, 2.5, -1.0, tA).numpy(),
                                  np.asarray(jt.geset(jlay, 2.5, -1.0, jA)))
    mask_t = tt.tri_mask(tlay, stt.Uplo.Lower)
    mask_j = jt.tri_mask(jlay, st.Uplo.Lower)
    _close(tt.tzadd(mask_t, 0.3, tA, -1.2, tB).numpy(), jt.tzadd(mask_j, 0.3, jA, -1.2, jB), 2)
    np.testing.assert_array_equal(tt.tzcopy(mask_t, tA, tB).numpy(),
                                  np.asarray(jt.tzcopy(mask_j, jA, jB)))
    _close(tt.tzscale(mask_t, 3.0, 4.0, tA).numpy(), jt.tzscale(mask_j, 3.0, 4.0, jA))
    for uplo in ("Lower", "Upper"):
        np.testing.assert_array_equal(
            tt.tzset(tlay, stt.Uplo[uplo], 2.5, -1.0, tA).numpy(),
            np.asarray(jt.tzset(jlay, st.Uplo[uplo], 2.5, -1.0, jA)))
    jZ, tZ = _tiles(_rand((37, 29), 9, complex_=True))
    for conj in (False, True):
        np.testing.assert_array_equal(tt.batch_transpose(tZ, conj).resolve_conj().numpy(),
                                      np.asarray(jt.batch_transpose(jZ, conj)))


# ---------------------------------------------------------------------------
# internal/norms.py
# ---------------------------------------------------------------------------

NORMS = ["One", "Inf", "Max", "Fro"]


@pytest.mark.parametrize("complex_", [False, True])
def test_genorm_every_norm_and_scope_matches_jax(complex_):
    jlay, tlay = _layouts()
    jA, tA = _tiles(_rand((37, 29), 10, complex_=complex_))
    for name in NORMS:
        got = tn.genorm(stt.Norm[name], tA, tlay)
        assert got.dim() == 0
        for ok in (True, False):  # the JAX package's kernel route and its plain one
            _close(float(got), float(jn.genorm(st.Norm[name], jA, jlay, pallas_ok=ok)), 37)
    _close(tn.genorm(stt.Norm.One, tA, tlay, stt.NormScope.Columns).numpy(),
           jn.genorm(st.Norm.One, jA, jlay, st.NormScope.Columns), 37)
    _close(tn.genorm(stt.Norm.Inf, tA, tlay, stt.NormScope.Rows).numpy(),
           jn.genorm(st.Norm.Inf, jA, jlay, st.NormScope.Rows), 29)
    with pytest.raises(stt.SlateError):
        tn.genorm(stt.Norm.Max, tA, tlay, stt.NormScope.Columns)
    z = tl.tiles_from_global(torch.zeros(37, 29, dtype=torch.float64), tlay)
    assert float(tn.genorm(stt.Norm.Fro, z, tlay)) == 0.0


@pytest.mark.parametrize("complex_", [False, True])
def test_trnorm_synorm_henorm_match_jax(complex_):
    jlay = jl.TileLayout(37, 37, 8, 8, 2, 2)
    tlay = tl.TileLayout(37, 37, 8, 8, 2, 2)
    a = _rand((37, 37), 11, complex_=complex_)
    jA = jl.tiles_from_global(jnp.asarray(a), jlay)
    tA = tl.tiles_from_global(torch.from_numpy(a), tlay)
    for name, uplo in itertools.product(NORMS, ["Lower", "Upper"]):
        for diag in ("NonUnit", "Unit"):
            ref = jn.trnorm(st.Norm[name], jA, jlay, st.Uplo[uplo], st.Diag[diag])
            got = tn.trnorm(stt.Norm[name], tA, tlay, stt.Uplo[uplo], stt.Diag[diag])
            _close(float(got), float(ref), 37)
        for fn in ("synorm", "henorm"):
            ref = getattr(jn, fn)(st.Norm[name], jA, jlay, st.Uplo[uplo])
            got = getattr(tn, fn)(stt.Norm[name], tA, tlay, stt.Uplo[uplo])
            _close(float(got), float(ref), 74)


@pytest.mark.parametrize("name", NORMS)
def test_norm_routing_follows_jax(monkeypatch, name):
    """genorm takes every per-tile statistic from the kernel wrapper
    (one call, two for Fro: max_sumsq, then the scaled fro_sumsq with
    its skip flag), on the stored tiles with the layout's counts;
    trnorm, synorm and henorm never call it, as in the JAX package."""
    calls = []
    wrapper = pk.tile_norms

    def spy(T, kind, **kw):
        calls.append(kind)
        assert sorted(kw) == (["cols", "rows", "scale", "skip"] if kind == "fro_sumsq"
                              else ["cols", "rows"]), kw
        return wrapper(T, kind, **kw)

    monkeypatch.setattr(pk, "tile_norms", spy)
    tlay = tl.TileLayout(37, 37, 8, 8, 2, 2)
    tA = tl.tiles_from_global(torch.from_numpy(_rand((37, 37), 19)), tlay)
    tn.genorm(stt.Norm[name], tA, tlay)
    assert calls == {"One": ["one"], "Inf": ["inf"], "Max": ["max"],
                     "Fro": ["max_sumsq", "fro_sumsq"]}[name]
    calls.clear()
    for uplo in (stt.Uplo.Lower, stt.Uplo.Upper):
        tn.trnorm(stt.Norm[name], tA, tlay, uplo)
        tn.synorm(stt.Norm[name], tA, tlay, uplo)
        tn.henorm(stt.Norm[name], tA, tlay, uplo)
    assert calls == []


# ---------------------------------------------------------------------------
# drivers/aux.py on a 2 x 2 logical grid
# ---------------------------------------------------------------------------


def _carry(M):
    """The JAX matrix M in this package (same storage, CPU)."""
    return stt.matrix_from_reference(
        np.asarray(M.data), m=M.layout.m, n=M.layout.n, mb=M.layout.mb, nb=M.layout.nb,
        p=M.layout.p, q=M.layout.q, kind=type(M).__name__, uplo=M.uplo.name, op=M.op.name,
        diag=M.diag.name, device="cpu")


def _same(got, ref, k=1):
    assert type(got).__name__ == type(ref).__name__
    _close(got.data.numpy(), ref.data, k)
    _close(got.to_global().numpy(), ref.to_global(), k)


def test_aux_elementwise_drivers_match_jax(grid22):
    a, b = _rand((37, 29), 12), _rand((37, 29), 13)
    jA, jB = st.Matrix.from_global(a, 8, grid=grid22), st.Matrix.from_global(b, 8, grid=grid22)
    tA, tB = _carry(jA), _carry(jB)
    _same(stt.add(0.5, tA, 2.0, tB), st.add(0.5, jA, 2.0, jB), 2)
    _same(stt.copy(tA, tB), st.copy(jA, jB))
    _same(stt.scale(3.0, 7.0, tA), st.scale(3.0, 7.0, jA))
    R, C = _rand((37,), 14), _rand((29,), 15)
    _same(stt.scale_row_col(torch.from_numpy(R), torch.from_numpy(C), tA),
          st.scale_row_col(jnp.asarray(R), jnp.asarray(C), jA), 2)
    _same(stt.set(1.5, -4.0, tA), st.set(1.5, -4.0, jA))
    _same(stt.set_lambdas(lambda i, j: i * 100 + j, tA),
          st.set_lambdas(lambda i, j: i * 100 + j, jA))
    # a different layout on the other side: through the global tensors
    jC = st.Matrix.from_global(b, 16, grid=grid22)
    tC = _carry(jC)
    _same(stt.add(0.5, tA, 2.0, tC), st.add(0.5, jA, 2.0, jC), 2)
    _same(stt.copy(tA, tC), st.copy(jA, jC))
    # the trapezoid kinds touch their triangle only
    h = _rand((29, 29), 16)
    for uplo in ("Lower", "Upper"):
        jT = st.TriangularMatrix.from_global(h, 8, grid=grid22, uplo=st.Uplo[uplo])
        jT2 = st.TriangularMatrix.from_global(h.T, 8, grid=grid22, uplo=st.Uplo[uplo])
        tT, tT2 = _carry(jT), _carry(jT2)
        _same(stt.add(0.5, tT2, 2.0, tT), st.add(0.5, jT2, 2.0, jT), 2)
        _same(stt.scale(3.0, 7.0, tT), st.scale(3.0, 7.0, jT))
        _same(stt.set(1.5, -4.0, tT), st.set(1.5, -4.0, jT))


@pytest.mark.parametrize("complex_", [False, True])
def test_aux_norm_and_colnorms_match_jax(grid22, complex_):
    a = _rand((37, 29), 17, complex_=complex_)
    jA = st.Matrix.from_global(a, 8, grid=grid22)
    tA = _carry(jA)
    for name in NORMS:
        _close(float(stt.norm(stt.Norm[name], tA)), float(st.norm(st.Norm[name], jA)), 37)
    _close(stt.colNorms(stt.Norm.One, tA).numpy(), st.colNorms(st.Norm.One, jA), 37)
    ref = np.abs(a).sum(0)
    _close(stt.colNorms(stt.Norm.One, tA).numpy(), ref, 37)
    # the transposed view: resolved first
    _close(float(stt.norm(stt.Norm.One, stt.conj_transpose(tA))), np.abs(a).sum(1).max(), 29)
    h = _rand((29, 29), 18, complex_=complex_)
    kinds = [("HermitianMatrix", "Lower", "NonUnit"), ("SymmetricMatrix", "Upper", "NonUnit"),
             ("TriangularMatrix", "Lower", "Unit"), ("TriangularMatrix", "Upper", "NonUnit")]
    for kind, uplo, diag in kinds:
        extra = {"diag": st.Diag[diag]} if kind == "TriangularMatrix" else {}
        jH = getattr(st, kind).from_global(h, 8, grid=grid22, uplo=st.Uplo[uplo], **extra)
        tH = _carry(jH)
        for name in NORMS:
            _close(float(stt.norm(stt.Norm[name], tH)), float(st.norm(st.Norm[name], jH)), 58)
