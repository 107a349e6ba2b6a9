"""The host side of the gemm_sub / syrk_diag kernel, on the CPU:
``gemm_sub_plan`` (the tile variant and the K split of one call) as a
pure function of the shape and of the tiles the kernel reports
(``slate_gemm_layout_*``, checked when the library loads), and the plan
run in numpy (each block's K range, the tiles above the diagonal skipped
by syrk_diag, the partials summed in order) against the JAX package's
Pallas kernels in interpret mode.

Two stand-in layouts play the kernel's report: the one the H100 build
gives (128 / 64 tiles, K slices of 32, one or two blocks an SM) and a
small one that makes every branch of the policy reachable at test
sizes.  Tolerance: ``50 k eps
max|ref|``, as in tests/test_pallas_panels.py."""

import jax.numpy as jnp
import numpy as np
import pytest

from slate_tpu.ops.pallas import panel_kernels as jpk
from slate_tpu_torch.ops.hopper import panel_kernels as pk

GT = pk.GemmTile
LAYOUTS = {
    "h100_f64": ((GT(128, 32, 1), GT(64, 32, 2)), 132),
    "h100_f32": ((GT(128, 32, 2), GT(64, 32, 4)), 132),
    "small": ((GT(16, 8, 1), GT(8, 4, 2)), 16),
}
# the posv shape classes at n = 16384 (ops/chol_kernels.py: _syrk_lower),
# ragged shapes, K under one slice, K = 0
SHAPES = [(4096, 4096, 8192), (2048, 2048, 8192), (1024, 1024, 2048), (512, 512, 8192),
          (512, 512, 1024), (256, 256, 8192), (256, 256, 512), (1601, 1550, 333),
          (129, 127, 8193), (70, 33, 3000), (5, 3, 1), (64, 64, 0), (7, 9, 300)]


def _chunks(plan, K):
    """The K range of each block along K, as the kernel takes it."""
    return [(z * plan.kchunk, K if z == plan.ksplit - 1 else (z + 1) * plan.kchunk)
            for z in range(plan.ksplit)]


def _tile_count(M, N, bm, lower):
    tm, tn = -(-M // bm), -(-N // bm)
    return tm * (tm + 1) // 2 if lower else tm * tn


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("M,N,K", SHAPES)
@pytest.mark.parametrize("lower", [False, True])
def test_gemm_sub_plan_slices_and_tiles(layout, M, N, K, lower):
    tiles, sms = LAYOUTS[layout]
    if lower:
        N = M
    plan = pk.gemm_sub_plan(M, N, K, lower, tiles, sms)
    assert 0 <= plan.variant < len(tiles)  # a tile the kernel reports
    tile = tiles[plan.variant]
    assert plan.ksplit >= 1 and plan.kchunk % tile.bk == 0 and plan.kchunk >= tile.bk
    chunks = _chunks(plan, K)
    assert chunks[0][0] == 0 and chunks[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))  # K covered once, in order
    if plan.ksplit > 1:
        # every split block is at least one K slice deep, and all but the
        # last at least MIN_SPLIT_DEPTH
        assert all(hi - lo >= tile.bk for lo, hi in chunks)
        assert all(hi - lo >= pk.MIN_SPLIT_DEPTH for lo, hi in chunks[:-1])
    most = 1  # the deepest split the policy allows
    while K // (2 * most) >= pk.MIN_SPLIT_DEPTH:
        most *= 2
    assert plan.ksplit <= most
    blocks = _tile_count(M, N, tile.bm, lower) * plan.ksplit
    if plan.variant < len(tiles) - 1:  # a larger tile is kept only when it fills the card
        assert 10 * blocks >= 9 * tile.per_sm * sms
    for big in tiles[:plan.variant]:  # the larger tiles could not fill it
        assert 10 * _tile_count(M, N, big.bm, lower) * most < 9 * big.per_sm * sms


@pytest.mark.parametrize("layout", ["h100_f64", "h100_f32"])
def test_gemm_sub_plan_of_large_outputs_does_not_split(layout):
    tiles, sms = LAYOUTS[layout]
    for M, N, K in [(4096, 4096, 8192), (2048, 2048, 8192), (2048, 2048, 4096)]:
        assert pk.gemm_sub_plan(M, N, K, False, tiles, sms) == (0, 1, K)


def _run_plan(c, a, b, plan, tile, lower):
    """The kernel's arithmetic order at block level in numpy: each block
    along K forms its partial product, the partials are summed in order
    (subk_reduce), tiles wholly above the diagonal are never computed and
    syrk_diag writes only r >= c.  Entries no block writes stay NaN."""
    M, N = c.shape
    K = a.shape[1]
    out = np.full_like(c, np.nan)
    bm = tile.bm
    for m0 in range(0, M, bm):
        for n0 in range(0, N, bm):
            if lower and n0 > m0 + bm - 1:
                continue
            rs, cs = slice(m0, m0 + bm), slice(n0, n0 + bm)
            parts = [a[rs, lo:hi] @ b[cs, lo:hi].T for lo, hi in _chunks(plan, K)]
            acc = parts[0] if plan.ksplit == 1 else sum(parts[1:], parts[0])
            blk = c[rs, cs] - acc
            if lower:
                r = np.arange(m0, min(M, m0 + bm))[:, None]
                cc = np.arange(n0, min(N, n0 + bm))[None, :]
                blk = np.where(r >= cc, blk, out[rs, cs])
            out[rs, cs] = blk
    if lower:
        out = np.where(np.tril(np.ones((M, N), bool)), out, c)
    return out


def _tol(dtype, k, ref):
    return 50 * max(k, 1) * np.finfo(dtype).eps * max(float(np.abs(ref).max()), 1.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("M,N,K", [(40, 24, 1100), (8, 8, 600), (17, 30, 7), (33, 33, 2048)])
def test_gemm_sub_plan_run_in_numpy_matches_pallas(dtype, M, N, K):
    tiles, sms = LAYOUTS["small"]
    rng = np.random.default_rng(M * N + K)
    c, a, b = (rng.standard_normal(s).astype(dtype) for s in ((M, N), (M, K), (N, K)))
    plan = pk.gemm_sub_plan(M, N, K, False, tiles, sms)
    if K >= 2 * pk.MIN_SPLIT_DEPTH:
        assert plan.ksplit > 1  # the small layout splits these
    got = _run_plan(c, a, b, plan, tiles[plan.variant], False)
    ref = np.asarray(jpk.gemm_sub_pallas(*map(jnp.asarray, (c, a, b)), interpret=True))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype, K, ref))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("t,K", [(40, 1100), (23, 5), (64, 4096), (9, 600)])
def test_syrk_diag_plan_run_in_numpy_matches_pallas(dtype, t, K):
    tiles, sms = LAYOUTS["small"]
    rng = np.random.default_rng(t + K)
    c, a = rng.standard_normal((t, t)).astype(dtype), rng.standard_normal((t, K)).astype(dtype)
    plan = pk.gemm_sub_plan(t, t, K, True, tiles, sms)
    got = _run_plan(c, a, a, plan, tiles[plan.variant], True)
    ref = np.asarray(jpk.syrk_diag_pallas(jnp.asarray(c), jnp.asarray(a), interpret=True))
    assert np.isfinite(got).all()  # the skipped tiles cover no lower entry
    np.testing.assert_array_equal(np.triu(got, 1), np.triu(c, 1))
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype, K, ref))


def test_gemm_layout_check_refuses_a_layout_the_plan_cannot_use():
    def report(layout):
        def query(v, bm, bk, per_sm):
            bm._obj.value, bk._obj.value, per_sm._obj.value = layout[v]
            return 0
        return query

    assert pk._gemm_tiles(report([(128, 16, 1), (64, 16, 2)]), "f64") == (
        GT(128, 16, 1), GT(64, 16, 2))
    for bad in ([(64, 16, 2), (128, 16, 1)],   # not largest first
                [(128, 16, 0), (64, 16, 2)],   # no block fits on an SM
                [(128, 24, 1), (64, 16, 2)]):  # a K slice that does not divide the split depth
        with pytest.raises(RuntimeError):
            pk._gemm_tiles(report(bad), "f64")
