"""Port parity: the tile layout, the matrix classes and the storage
converter of slate_tpu_torch against the JAX package.

Index arrays and packed tiles must agree exactly (they are integer
index math and data movement); every operand comes from numpy with a
seed and goes to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu.matrix.base import conj_transpose as jconj_transpose
from slate_tpu.parallel import layout as jlayout
from slate_tpu_torch.convert import matrix_from_reference
from slate_tpu_torch.matrix.base import conj_transpose
from slate_tpu_torch.parallel import layout as tlayout

torch.set_num_threads(1)

LAYOUTS = [
    (10, 7, 4, 3, 1, 1),
    (64, 64, 16, 16, 2, 2),
    (37, 53, 8, 16, 2, 4),
    (100, 30, 32, 8, 3, 1),
    (5, 5, 8, 8, 1, 2),
]

_INDEX_FIELDS = (
    "row_gather", "col_gather", "row_scatter", "col_scatter",
    "row_mask_np", "col_mask_np", "global_rows_np", "global_cols_np",
)


def _data(m, n, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal((m, n))
    return a.astype(dtype)


@pytest.mark.parametrize("dims", LAYOUTS)
def test_tile_layout_index_arrays_match(dims):
    jl, tl = jlayout.TileLayout(*dims), tlayout.TileLayout(*dims)
    for f in ("mt", "nt", "mtl", "ntl", "P", "Q", "storage_shape", "trivial_perm"):
        assert getattr(jl, f) == getattr(tl, f), f
    for f in _INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(jl, f), getattr(tl, f), err_msg=f)
    np.testing.assert_array_equal(
        np.asarray(jl.element_mask()), tl.element_mask().numpy()
    )
    assert jl.transposed().storage_shape == tl.transposed().storage_shape
    for i in range(jl.mt):
        assert jl.tileMb(i) == tl.tileMb(i)
    for j in range(jl.nt):
        assert jl.tileNb(j) == tl.tileNb(j)


@pytest.mark.parametrize("dims", LAYOUTS)
def test_tiles_round_trip_and_match_exactly(dims):
    m, n = dims[:2]
    a = _data(m, n, np.float64, seed=sum(dims))
    jl, tl = jlayout.TileLayout(*dims), tlayout.TileLayout(*dims)
    jt = np.asarray(jlayout.tiles_from_global(jnp.asarray(a), jl))
    tt = tlayout.tiles_from_global(torch.from_numpy(a), tl)
    np.testing.assert_array_equal(jt, tt.numpy())
    np.testing.assert_array_equal(tlayout.tiles_to_global(tt, tl).numpy(), a)
    np.testing.assert_array_equal(
        np.asarray(jlayout.eye_splice(jl, jnp.asarray(jt), 2.5)),
        tlayout.eye_splice(tl, tt, 2.5).numpy(),
    )


def _grids(p, q, devices):
    jgrid = st.ProcessGrid.from_devices(devices[: p * q], p=p, q=q)
    return jgrid, stt.ProcessGrid(torch.device("cpu"), p, q)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("pq", [(1, 1), (2, 2)])
def test_hermitian_full_global_and_resolved_view(dtype, uplo, pq, devices):
    n, mb = 23, 8
    a = _data(n, n, dtype, seed=3)
    jgrid, tgrid = _grids(*pq, devices)
    JA = st.HermitianMatrix.from_global(
        jnp.asarray(a), mb, grid=jgrid, uplo=st.Uplo[uplo])
    TA = stt.HermitianMatrix.from_global(a, mb, grid=tgrid, uplo=stt.Uplo[uplo])
    np.testing.assert_array_equal(np.asarray(JA.data), TA.data.numpy())
    np.testing.assert_array_equal(np.asarray(JA.full_global()), TA.full_global().numpy())
    JR = jconj_transpose(JA).resolved()
    TR = conj_transpose(TA).resolved()
    assert TR.uplo.name == JR.uplo.name
    assert TR.layout.storage_shape == JR.layout.storage_shape
    np.testing.assert_array_equal(np.asarray(JR.data), TR.data.numpy())
    np.testing.assert_array_equal(
        np.asarray(jconj_transpose(JA).to_global()),
        conj_transpose(TA).to_global().resolve_conj().numpy(),
    )


@pytest.mark.parametrize("kind", ["Matrix", "TriangularMatrix", "HermitianMatrix"])
@pytest.mark.parametrize("pq", [(1, 1), (2, 4)])
def test_matrix_from_reference_reproduces_storage(kind, pq, devices):
    m = n = 30
    a = _data(m, n, np.float64, seed=11)
    jgrid, _ = _grids(*pq, devices)
    cls = getattr(st, kind)
    JA = cls.from_global(jnp.asarray(a), 8, grid=jgrid)
    lay = JA.layout
    TA = matrix_from_reference(
        np.asarray(JA.data), m=lay.m, n=lay.n, mb=lay.mb, nb=lay.nb,
        p=lay.p, q=lay.q, kind=kind, uplo=JA.uplo.name, op=JA.op.name,
        diag=JA.diag.name, device="cpu",
    )
    assert type(TA).__name__ == kind
    assert TA.data.dtype == torch.float64
    np.testing.assert_array_equal(np.asarray(JA.data), TA.data.numpy())
    np.testing.assert_array_equal(np.asarray(JA.to_global()), TA.to_global().numpy())
    # the same view resolves the same way in both packages
    np.testing.assert_array_equal(
        np.asarray(jconj_transpose(JA).resolved().data),
        conj_transpose(TA).resolved().data.numpy(),
    )
