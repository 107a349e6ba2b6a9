"""Port parity: the process-grid meshes (``parallel/grid.py``
``ProcessGrid.from_ranks``) and the mesh layouts (``parallel/layout.py``,
``BaseMatrix`` on a mesh), on gloo ranks against the JAX package's
8-virtual-device mesh.

The port's side of ``tests/test_layout.py`` (its six tests, with their
parameters), the grid orders, the constructor's refusals and the
distributed operands the drivers refuse (the band, indefinite, mixed and
remaining dense drivers, the eigensolvers and the SVD, naming ROADMAP.md
Queue 1 item 8b2 / 8c).  The same seeded numpy operands
go to the JAX package and to a pool of 8 gloo ranks
(``torch_mesh_pool``); every rank's block must be the JAX package's
shard of the same mesh position, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu.parallel import layout as jlayout
from slate_tpu_torch.exceptions import DistributedException
from slate_tpu_torch.parallel import layout as tlayout
from torch_mesh_pool import MeshPool

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = MeshPool(8, tmp_path_factory.mktemp("mesh"))
    yield p
    p.close()


def _shards(T, jgrid):
    """The JAX package's shard of each mesh position (r, c)."""
    by_dev = {s.device: np.asarray(s.data) for s in T.addressable_shards}
    devs = np.asarray(jgrid.mesh.devices)
    return {(r, c): by_dev[devs[r, c]] for r in range(jgrid.p) for c in range(jgrid.q)}


@pytest.mark.parametrize(
    "m,n,mb,nb,p,q",
    [
        (8, 8, 4, 4, 1, 1),
        (100, 80, 16, 16, 2, 2),
        (33, 65, 8, 16, 4, 2),
        (7, 7, 8, 8, 2, 2),  # single partial tile
        (64, 64, 16, 16, 3, 2),  # p doesn't divide mt
    ],
)
def test_roundtrip(pool, m, n, mb, nb, p, q):
    """from_global on a p x q mesh keeps each rank's block of the JAX
    package's storage; to_global gathers A back on every rank."""
    A = np.random.default_rng(0).standard_normal((m, n))
    jl = jlayout.TileLayout(m, n, mb, nb, p, q)
    T = np.asarray(jlayout.tiles_from_global(jnp.asarray(A), jl))
    res = [x for x in pool.run("layout", grid=(p, q, "Col", p * q), a=A, mb=mb, nb=nb)
           if x is not None]
    assert len(res) == p * q
    for x in res:
        r, c = x["position"]
        np.testing.assert_array_equal(x["block"],
                                      T[r * jl.mtl:(r + 1) * jl.mtl, c * jl.ntl:(c + 1) * jl.ntl])
        np.testing.assert_array_equal(x["global"], A)
        np.testing.assert_array_equal(x["storage"], T)
        # shard() keeps this rank's block of whole storage-order data
        np.testing.assert_array_equal(x["shard"], x["block"])


def test_storage_permutation_is_cyclic(pool):
    """Storage block r holds process row r's tiles, and the rank at (r, c)
    of the mesh owns exactly the tiles i % p == r, j % q == c."""
    tl = tlayout.TileLayout(64, 64, 8, 8, 2, 2)  # mt = nt = 8
    for s in range(tl.P):
        i = tl.lrow(s)
        assert tl.srow(i) == s
        assert i % tl.p == s // tl.mtl
    a = np.arange(64 * 64, dtype=np.float64).reshape(64, 64)
    for x in pool.run("layout", grid=(2, 2, "Col", 4), a=a, mb=8, nb=8):
        if x is None:
            continue
        r, c = x["position"]
        want = np.array([[i % 2 == r and j % 2 == c for j in range(8)] for i in range(8)])
        np.testing.assert_array_equal(x["own"], want)


def test_tile_sizes_ragged():
    jl, tl = jlayout.TileLayout(100, 70, 16, 32, 2, 2), tlayout.TileLayout(100, 70, 16, 32, 2, 2)
    assert (tl.mt, tl.nt) == (jl.mt, jl.nt) == (7, 3)
    assert [tl.tileMb(i) for i in range(tl.mt)] == [jl.tileMb(i) for i in range(jl.mt)]
    assert [tl.tileNb(j) for j in range(tl.nt)] == [jl.tileNb(j) for j in range(jl.nt)]
    np.testing.assert_array_equal(tl.element_mask().numpy(), np.asarray(jl.element_mask()))
    assert int(tl.element_mask().sum()) == 100 * 70
    assert tl.local_shape == (jl.mtl, jl.ntl, 16, 32)
    z = tlayout.zeros_tiles(tl, torch.float64)
    assert tuple(z.shape) == jlayout.zeros_tiles(jl).shape and not z.any()


def test_tile_rank_cyclic():
    jl, tl = jlayout.TileLayout(64, 64, 8, 8, 2, 3), tlayout.TileLayout(64, 64, 8, 8, 2, 3)
    for i in range(tl.mt):
        for j in range(tl.nt):
            assert tl.tileRank(i, j) == jl.tileRank(i, j) == (i % 2, j % 3)
            for r in range(2):
                for c in range(3):
                    assert tl.tileIsLocal(i, j, r, c) == jl.tileIsLocal(i, j, r, c)
    assert tl.with_grid(4, 2) == tlayout.TileLayout(64, 64, 8, 8, 4, 2)


@pytest.mark.parametrize("order", ["Col", "Row"])
@pytest.mark.parametrize("pq", [(2, 2), (4, 2)])
def test_sharded_placement(pool, devices, order, pq):
    """Each rank's block is the JAX package's shard of its mesh position,
    with rank k at (k % p, k // p) for GridOrder.Col and (k // q, k % q)
    for GridOrder.Row, as device k is in the JAX package."""
    p, q = pq
    jgrid = st.ProcessGrid.from_devices(devices[:p * q], p=p, q=q, order=st.GridOrder[order])
    a = np.arange(64 * 64, dtype=np.float64).reshape(64, 64)
    JA = st.Matrix.from_global(jnp.asarray(a), 8, grid=jgrid)
    shards = _shards(JA.data, jgrid)
    devs = np.asarray(jgrid.mesh.devices)
    for x in pool.run("layout", grid=(p, q, order, p * q), a=a, mb=8, nb=8):
        if x is None:
            continue
        k = x["rank"]
        want = (k % p, k // p) if order == "Col" else (k // q, k % q)
        assert x["position"] == want
        assert devs[want] == jax.devices()[k]
        np.testing.assert_array_equal(x["block"], shards[want])
    # the block of position (0, 0): tile (0, 0) is global tile (0, 0) and
    # local tile (1, 1) is global tile (p, q)
    blk = shards[(0, 0)]
    np.testing.assert_array_equal(blk[0, 0], a[0:8, 0:8])
    np.testing.assert_array_equal(blk[1, 1], a[8 * p:8 * p + 8, 8 * q:8 * q + 8])


def test_grid_rows_and_columns(pool):
    """The row ('q') and column ('p') gathers reach the right ranks in
    axis order, and the transposed grid swaps them."""
    for x in pool.run("grid", grid=(4, 2, "Col", 8)):
        r, c = x["position"]
        assert x["ranks"] == tuple(tuple(rr + 4 * cc for cc in range(2)) for rr in range(4))
        np.testing.assert_array_equal(x["row"], [r + 4 * cc for cc in range(2)])
        np.testing.assert_array_equal(x["col"], [rr + 4 * c for rr in range(4)])
    g = stt.ProcessGrid(torch.device("cpu"), 2, 3, stt.GridOrder.Col, ((0, 2, 4), (1, 3, 5)), 3)
    t = g.transposed()
    assert (t.p, t.q, t.order, t.position) == (3, 2, stt.GridOrder.Row, (1, 1))
    assert t.transposed() == g
    assert g.axis_ranks("q") == (1, 3, 5) and g.axis_ranks("p") == (2, 3)


def test_eye_splice_pads_diagonal():
    tl = tlayout.TileLayout(10, 10, 4, 4, 1, 1)  # padded to 12 x 12
    T = tlayout.eye_splice(tl, tlayout.tiles_from_global(torch.zeros(10, 10), tl))
    A = tlayout.tiles_to_global(T, tlayout.TileLayout(12, 12, 4, 4, 1, 1)).numpy()
    jl = jlayout.TileLayout(10, 10, 4, 4, 1, 1)
    J = np.asarray(jlayout.eye_splice(jl, jlayout.tiles_from_global(jnp.zeros((10, 10)), jl)))
    np.testing.assert_array_equal(T.numpy(), J)
    assert A[:10, :10].sum() == 0
    np.testing.assert_array_equal(np.diag(A)[10:], [1.0, 1.0])


def test_is_distributed_and_the_block_index_maps():
    """``ProcessGrid.is_distributed`` holds for a mesh of more than one
    process only, and ``layout.index_maps`` / ``local_tiles`` on such a
    mesh give each rank the block of the whole storage's maps."""
    dev = torch.device("cpu")
    assert not stt.ProcessGrid.single("cpu").is_distributed
    assert not stt.ProcessGrid(dev, 2, 2).is_distributed  # a logical grid
    assert not stt.ProcessGrid(dev, 1, 1, ranks=((0,),), rank=0).is_distributed
    tl = tlayout.TileLayout(50, 37, 16, 8, 2, 2)
    gr, gc, valid = tlayout.index_maps(tl)
    whole_r, whole_c = (x.expand(tl.storage_shape) for x in (gr, gc))
    assert torch.equal(valid, tl.element_mask())
    ranks = ((0, 2), (1, 3))
    for k in range(4):
        g = stt.ProcessGrid(dev, 2, 2, ranks=ranks, rank=k)
        assert g.is_distributed
        r, c = g.position
        lr, lc, lv = tlayout.index_maps(tl, grid=g)
        for part, whole in ((lr, whole_r), (lc, whole_c), (lv, valid)):
            block = tlayout.local_block(whole, tl, r, c)
            assert torch.equal(part.expand(tl.local_shape), block)
            assert torch.equal(tlayout.local_tiles(whole, tl, g), block)


def test_grid_constructor_refusals(pool, devices):
    """The constructor's DistributedException texts are the JAX package's;
    a CUDA grid on gloo and a mesh without torch.distributed raise."""
    for p, q in ((3, 2), (0, 4)):
        with pytest.raises(st.DistributedException) as e:
            st.ProcessGrid.from_devices(devices[:4], p=p, q=q)
        got = pool.run("make_grid", grid=(2, 2, "Col", 4), p=p, q=q, n=4)
        assert [x for x in got if x is not None] == [str(e.value)] * 4
    got = pool.run("make_grid", grid=(2, 2, "Col", 4), p=2, q=2, n=4, device="cuda:0")
    assert all("NCCL" in x for x in got if x is not None)
    # no device named and no CUDA: the mesh raises, never picks the CPU
    got = pool.run("make_grid", grid=(2, 2, "Col", 4), p=2, q=2, n=4, device=None)
    assert all("no CUDA device" in x for x in got if x is not None)
    with pytest.raises(DistributedException, match="not initialized"):
        stt.ProcessGrid.from_ranks(p=1, q=1, device="cpu")


@pytest.mark.parametrize("routine,item", [
    ("band.pbsv", "8b2"), ("indefinite.hesv", "8b2"), ("mixed.gesv_mixed", "8b2"),
    ("lu.getrf_nopiv", "8b2"), ("qr.gelqf", "8b2"), ("eig.heev", "8c"), ("svd.svd", "8c"),
])
def test_distributed_operands_raise_naming_the_item(pool, routine, item):
    """The drivers whose mesh paths are not ported refuse a distributed
    operand with DistributedException naming the Queue 1 item; none
    gathers it (trsm, the factorizations and their solves take their mesh
    paths: tests/test_torch_spmd_*.py)."""
    n = 32
    a = np.tril(np.random.default_rng(1).standard_normal((n, n))) + n * np.eye(n)
    kind = {"band.pbsv": "HermitianMatrix", "indefinite.hesv": "HermitianMatrix",
            "eig.heev": "HermitianMatrix"}.get(routine, "Matrix")
    args = [(kind, a @ a.T, 8, None, {})]
    if routine in ("band.pbsv", "indefinite.hesv", "mixed.gesv_mixed"):
        args.append(("Matrix", a[:, :4], 8, None, {}))
    got = [x for x in pool.run("raises", grid=(2, 2, "Col", 4), routine=routine, args=args)
           if x is not None]
    assert len(got) == 4
    for x in got:
        assert x["type"] == "DistributedException", x
        assert f"Queue 1 item {item}" in x["text"]
