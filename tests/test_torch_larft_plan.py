"""The host side of the larft kernel, on the CPU: ``larft_plan`` (the tile
variant and the row split of one call) as a pure function of the shape
and of the tiles the kernel reports (``slate_larft_layout_*``, checked
when the library loads), ``larft_chunks`` (the rows each chunk takes, by
the kernel's formula), and the plan run in numpy (each block sums its
chunk's rows of its tile on or above the diagonal, the partials are
summed in chunk order) against the JAX package's ``_larft_tinv_body``
and ``larft_pallas`` in interpret mode.

Stand-in layouts play the kernel's report: the one the H100 build gives
(128 / 64 tiles, slices of 32 rows, one or two blocks an SM in float64,
two or three in float32, where a diagonal 128 tile does 3/4 of a tile's
work) and a small one that splits the rows at test sizes.  Tolerance: ``50 M eps max|ref|``, as in
tests/test_torch_qr_kernels.py; the diagonal (one IEEE division each)
and the zeros below it are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.ops.pallas import panel_kernels as jpk
from slate_tpu_torch.ops.hopper import panel_kernels as pk

torch.set_num_threads(1)

LT = pk.LarftTile
LAYOUTS = {
    "h100_f64": ((LT(128, 32, 1, 4), LT(64, 32, 2, 4)), 132),
    "h100_f32": ((LT(128, 32, 2, 3), LT(64, 32, 3, 4)), 132),
    "small": ((LT(16, 8, 1, 3), LT(8, 4, 2, 4)), 16),
}
WIDTHS = [1, 5, 64, 200, 256, 1024]
HEIGHTS = [0, 7, 31, 33, 200, 2000, 24576, 32768]


def _tiles(w, bm):
    """(diagonal tiles, tiles above the diagonal) of a (w, w) output."""
    nt = -(-w // bm)
    return nt, nt * (nt - 1) // 2


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("M", HEIGHTS)
def test_larft_plan_covers_the_rows_once_in_whole_slices(layout, M, w):
    tiles, sms = LAYOUTS[layout]
    plan = pk.larft_plan(M, w, tiles, sms)
    assert plan == pk.larft_plan(M, w, tiles, sms)  # a pure function of its arguments
    # the largest tile no wider than w, else the smallest
    fits = [v for v, t in enumerate(tiles) if t.bm <= w]
    assert plan.variant == (fits[0] if fits else len(tiles) - 1)
    tile = tiles[plan.variant]
    nslices = -(-M // tile.bk)
    for n in (plan.diag_chunks, plan.off_chunks):
        chunks = pk.larft_chunks(M, tile.bk, n)
        assert len(chunks) == n >= 1
        assert chunks[0][0] == 0 and chunks[-1][1] == M
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))  # every row once, in order
        assert all(lo % tile.bk == 0 for lo, _ in chunks)  # whole slices ...
        assert all(hi % tile.bk == 0 for _, hi in chunks[:-1])  # ... except the last
        depths = [-(-(hi - lo) // tile.bk) for lo, hi in chunks]
        assert sum(depths) == nslices and max(depths) - min(depths) <= 1
        if n > 1:
            assert min(depths) >= pk.LARFT_MIN_SLICES
    nd, no = _tiles(w, tile.bm)
    blocks = pk.larft_blocks(plan, w, tile.bm)
    assert blocks == nd * plan.diag_chunks + no * plan.off_chunks
    slots = tile.per_sm * sms
    most = max(1, nslices // pk.LARFT_MIN_SLICES)
    if blocks > nd + no:  # split only as far as one wave of the card's block slots
        assert blocks <= slots
    if no:
        # a diagonal tile's chunks in the ratio of its work: a block's work
        # is the same to within rounding (or the bounds on the counts)
        want = plan.off_chunks * tile.diag_work / 4
        assert abs(plan.diag_chunks - want) <= 0.5 or plan.diag_chunks in (1, most)
        # one more chunk above the diagonal overflows the wave or the depth
        co = plan.off_chunks + 1
        cd = max(1, min(most, (co * tile.diag_work + 2) // 4))
        assert co > most or nd * cd + no * co > slots
    else:
        assert plan.diag_chunks == min(most, max(1, slots // nd))


@pytest.mark.parametrize("layout", ["h100_f64", "h100_f32"])
@pytest.mark.parametrize("M", [32768, 24576])
def test_larft_plan_fills_one_wave_at_the_main_path_shapes(layout, M):
    """The gels main path's base panels, V (32768, 256) and (24576, 256):
    3 tiles of 128, and one wave of the card less than a chunk of each
    tile (float64 exactly one block a slot; float32 gives the diagonal
    tiles 3/4 of the chunks of the tile above them)."""
    tiles, sms = LAYOUTS[layout]
    plan = pk.larft_plan(M, 256, tiles, sms)
    assert plan.variant == 0
    slots = tiles[0].per_sm * sms
    blocks = pk.larft_blocks(plan, 256, 128)
    assert slots - 3 < blocks <= slots
    if layout == "h100_f64":
        assert plan == (0, 44, 44) and blocks == slots
    else:
        assert plan == (0, 79, 105)


def _run_plan(V, taus, plan, tile):
    """The kernel's arithmetic order at block level in numpy: block
    (tile, chunk) forms its chunk's rows of the tile's Gram (tiles below
    the diagonal are never computed; a diagonal tile with less than a
    whole tile's work leaves its quadrant below the diagonal, NaN here),
    the finish sums each element's partials in chunk order and writes
    the strict upper part, 1 / tau on the diagonal (1e30 for tau = 0)
    and zeros below.  Entries no block computes stay NaN."""
    M, w = V.shape
    bm, half = tile.bm, tile.bm // 2
    acc = np.full((w, w), np.nan, V.dtype)
    for i0 in range(0, w, bm):
        for j0 in range(i0, w, bm):
            n = plan.diag_chunks if i0 == j0 else plan.off_chunks
            tot = None
            for lo, hi in pk.larft_chunks(M, tile.bk, n):
                part = V[lo:hi, i0:i0 + bm].T @ V[lo:hi, j0:j0 + bm]
                if i0 == j0 and tile.diag_work < 4:
                    part[half:, :half] = np.nan
                tot = part if tot is None else tot + part
            acc[i0:i0 + bm, j0:j0 + bm] = tot
    one = V.dtype.type(1)
    d = np.where(taus != 0, one / np.where(taus == 0, one, taus), V.dtype.type(pk.LARFT_BIG))
    return np.where(np.triu(np.ones((w, w), bool), 1), acc, 0) + np.diag(d).astype(V.dtype)


def _consistent(m, w, dtype, seed, dead=()):
    rng = np.random.default_rng(seed)
    V = np.tril(rng.standard_normal((m, w)), -1) * 0.1 + np.eye(m, w)
    sq = (V * V).sum(0)
    taus = np.where(sq > 0, 2.0 / np.where(sq > 0, sq, 1), 0)
    taus[list(dead)] = 0.0
    return V.astype(dtype), taus.astype(dtype)


def _tol(dtype, m, ref):
    return 50 * max(m, 1) * np.finfo(dtype).eps * max(float(np.abs(ref).max()), 1.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("M,w,dead,short", [
    (200, 20, (), 0),     # tiles of 16: 2 diagonal (5 chunks each) and 1 above (6)
    (96, 32, (0, 17), 0),
    (61, 40, (5,), 3),    # ragged rows and columns, a short taus vector
    (300, 7, (), 0),      # the 8 tile, 18 chunks
    (5, 3, (), 0),        # under one slice: one chunk
])
def test_larft_plan_run_in_numpy_matches_pallas(dtype, M, w, dead, short):
    tiles, sms = LAYOUTS["small"]
    V, taus = _consistent(M, w, dtype, seed=M + w, dead=dead)
    t = taus[: w - short]
    tp = np.r_[t, np.zeros(short, dtype)]
    plan = pk.larft_plan(M, w, tiles, sms)
    if M >= 61:
        assert plan.diag_chunks > 1  # the small layout splits these
    got = _run_plan(V, tp, plan, tiles[plan.variant])
    assert np.isfinite(got).all()  # the tiles computed cover the upper triangle
    ref = np.asarray(jpk._larft_tinv_body(jnp.asarray(V), jnp.asarray(tp)))
    np.testing.assert_array_equal(np.tril(got, -1), 0)
    np.testing.assert_array_equal(np.diag(got), np.diag(ref))
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype, M, ref))
    # T through the library solve and the tau = 0 masking, against the
    # JAX kernel's T
    T = pk._larft_finish(torch.from_numpy(got), torch.from_numpy(tp)).numpy()
    ref_t = np.asarray(jpk.larft_pallas(jnp.asarray(V), jnp.asarray(t), interpret=True))
    np.testing.assert_allclose(T, ref_t, rtol=0, atol=_tol(dtype, M, ref_t))
    absent = np.flatnonzero(tp == 0)
    assert not T[absent].any() and not T[:, absent].any()


def test_larft_layout_check_refuses_a_layout_the_plan_cannot_use():
    def report(layout):
        def query(v, *outs):
            for out, val in zip(outs, layout[v]):
                out._obj.value = val
            return 0
        return query

    assert pk._larft_tiles(report([(128, 32, 1, 4), (64, 32, 2, 4)]), "f64") == (
        LT(128, 32, 1, 4), LT(64, 32, 2, 4))
    for bad in ([(64, 32, 2, 4), (128, 32, 1, 4)],   # not largest first
                [(128, 32, 0, 4), (64, 32, 2, 4)],   # no block fits on an SM
                [(128, 32, 1, 5), (64, 32, 2, 4)]):  # a diagonal tile above a whole tile's work
        with pytest.raises(RuntimeError, match="larft kernel layout"):
            pk._larft_tiles(report(bad), "f64")
