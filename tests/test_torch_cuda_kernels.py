"""The Hopper kernels of slate_tpu_torch against their plain PyTorch
versions on the card, at ragged shapes and strided views that the main
path of chip_smoke.py does not reach, and the posv / gesv drivers on the
card at a small size.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  This file imports neither JAX nor the JAX package, so it runs
on a machine without them; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: ``50 n eps max|ref|``, as in tests/test_pallas_panels.py;
panel_lu, butterfly_level, tile_geadd, tile_transpose, the max of
tile_norms and the diagonal of larft's T^-1 are bit-identical to their
plain versions on the same device."""

import numpy as np
import pytest
import torch

from slate_tpu_torch.ops.hopper import panel_kernels as pk

torch.set_num_threads(1)

DTYPES = [np.float32, np.float64]


def _tol(dtype, n, ref):
    return 50 * n * np.finfo(dtype).eps * max(float(np.abs(ref).max()), 1.0)


def _rand(rng, m, n, dtype):
    return rng.standard_normal((m, n)).astype(dtype)


def _tri(rng, n, dtype, lower, unit):
    a = rng.standard_normal((n, n)) * 0.3
    t = np.tril(a, -1) if lower else np.triu(a, 1)
    d = np.ones(n) if unit else 2.0 + np.abs(rng.standard_normal(n))
    return (t + np.diag(d)).astype(dtype)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    pk.reset_launches()
    yield torch.device("cuda:0")
    pk.reset_launches()


def _both(x, dev):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t, t.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_chol_base_and_syrk_diag_ragged(dev, dtype):
    rng = np.random.default_rng(17)
    a = rng.standard_normal((77, 77))
    g = (a @ a.T + 77 * np.eye(77)).astype(dtype) + np.triu(_rand(rng, 77, 77, dtype), 1)
    g_cpu, g_dev = _both(g, dev)
    got = pk.chol_base(g_dev).cpu().numpy()
    ref = pk.chol_base(g_cpu).numpy()
    np.testing.assert_array_equal(np.triu(got, 1), np.triu(g, 1))
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype, 77, ref))

    # K = 1100 splits across blocks; C is a strided view
    c_cpu, c = _both(_rand(rng, 90, 90, dtype), dev)
    a_cpu, a = _both(_rand(rng, 70, 1100, dtype), dev)
    got = pk.syrk_diag(c[10:80, 5:75], a).cpu().numpy()
    ref = pk.syrk_diag(c_cpu[10:80, 5:75], a_cpu).numpy()
    np.testing.assert_array_equal(np.triu(got, 1), np.triu(ref, 1))
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype, 1100, ref))
    assert pk.LAUNCHES["chol_base"] == 1 and pk.LAUNCHES["syrk_diag"] == 1


def _spd_junk(rng, b, dtype):
    """An SPD block with randn junk above the diagonal."""
    x = rng.standard_normal((b, b))
    return (x @ x.T + b * np.eye(b)).astype(dtype) + np.triu(_rand(rng, b, b, dtype), 1)


def _chol_ratio(got, ref):
    """max |got - ref| / (10 sqrt(b) eps (|L||L|^T)_ij / L_jj) over the
    lower triangle, L = tril(ref): the tolerance of chip_smoke.py's
    phase 2 (NaN, and so a failure, where got is not finite)."""
    b = ref.shape[0]
    got, L = np.tril(got).astype(np.float64), np.tril(ref).astype(np.float64)
    scale = (np.abs(L) @ np.abs(L).T) / np.abs(np.diag(L))[None, :]
    limit = 10 * np.sqrt(b) * np.finfo(ref.dtype).eps * scale
    return float(np.max(np.where(np.tri(b, dtype=bool), np.abs(got - L) / limit, 0.0)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 31, 33, 77, 256, 512])
def test_chol_base_blocks(dev, dtype, b):
    """chol_base at the seams of its 32-column strips and tiles and at
    both block sizes of the posv path: within phase 2's tolerance of the
    plain version, the strict upper triangle bit for bit, one launch a
    call, two calls bitwise equal, and a strided view (lda > b) the same
    bits as the contiguous block."""
    rng = np.random.default_rng(b)
    g = _spd_junk(rng, b, dtype)
    g_cpu, g_dev = _both(g, dev)
    got = pk.chol_base(g_dev)
    assert pk.LAUNCHES["chol_base"] == 1
    again = pk.chol_base(g_dev)
    assert pk.LAUNCHES["chol_base"] == 2
    assert torch.equal(got, again)
    big = torch.zeros(b + 9, b + 13, dtype=g_dev.dtype, device=dev)
    big[4:4 + b, 6:6 + b] = g_dev
    assert torch.equal(pk.chol_base(big[4:4 + b, 6:6 + b]), got)
    got = got.cpu().numpy()
    np.testing.assert_array_equal(np.triu(got, 1), np.triu(g, 1))
    assert _chol_ratio(got, pk.chol_base_plain(g_cpu).numpy()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_chol_base_non_spd_gives_nan(dev, dtype):
    """A negative pivot in the third strip: NaN down its column and in
    the lower triangle after it, the block before it finite, the upper
    triangle untouched."""
    rng = np.random.default_rng(70)
    g = _spd_junk(rng, 256, dtype)
    g[70, 70] = -1.0
    got = pk.chol_base(_both(g, dev)[1]).cpu()
    assert bool(got[70:, 70].isnan().all())
    assert bool(torch.isfinite(torch.tril(got[:70, :70])).all())
    np.testing.assert_array_equal(np.triu(got.numpy(), 1), np.triu(g, 1))
    assert pk.LAUNCHES["chol_base"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [250, 3000])
def test_gemm_sub_strided_views(dev, dtype, k):
    rng = np.random.default_rng(k)
    big_cpu, big = _both(_rand(rng, 150, k + 50, dtype), dev)
    views = lambda m: (m[:70, :33], m[80:, :k], m[:33, 50:k + 50])  # noqa: E731
    got = pk.gemm_sub(*views(big)).cpu().numpy()
    ref = pk.gemm_sub(*views(big_cpu)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype, k, ref))
    assert pk.LAUNCHES["gemm_sub"] == 1


MODES = [(True, False, False), (True, True, False), (False, False, False), (False, False, True),
         (True, False, True)]


KB, TILE = pk.TRSM_KB, pk.TRSM_BN  # the trsm kernel's block step and column tile


def _trsm(t, b, lower, unit, trans):
    if lower:
        return pk.trsm_lower(t, b, unit=unit, transposed=trans)
    return pk.trsm_upper(t, b, transposed=trans)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lower,unit,trans", MODES)
@pytest.mark.parametrize("n,nrhs", [(101, 7), (300, 1), (KB - 1, 3), (KB, 1), (KB + 1, "tile+1"),
                                    (300, 3), (1000, "tile+1")])
def test_trsm_packed_storage(dev, dtype, lower, unit, trans, n, nrhs):
    """op(T) X = B with NaN in the unread triangle (and on the unread unit
    diagonal): the result is finite and agrees with the plain solve.  The
    shapes cross the kernel's seams: n = KB - 1, KB, KB + 1 (one block
    step), n not a multiple of KB, nrhs = 1 and one column tile + 1."""
    nrhs = TILE + 1 if nrhs == "tile+1" else nrhs
    rng = np.random.default_rng(n + 2 * lower + unit + 4 * trans)
    stored_lower = lower != trans
    t = _tri(rng, n, dtype, stored_lower, unit)
    ones = np.ones((n, n), bool)
    other = np.triu(ones, 0 if unit else 1) if stored_lower else np.tril(ones, -1 if not unit else 0)
    _, t_dev = _both(np.where(other, np.nan, t), dev)
    b_cpu, b = _both(_rand(rng, n, nrhs, dtype), dev)
    got = _trsm(t_dev, b, lower, unit, trans).cpu().numpy()
    ref = pk.trsm_plain(torch.from_numpy(t), b_cpu, lower, unit, trans).numpy()
    assert got.shape == (n, nrhs)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype, n, ref))
    assert pk.LAUNCHES["trsm_lower" if lower else "trsm_upper"] == pk.trsm_kernel_launches(n, nrhs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lower,unit,trans", MODES)
def test_trsm_strided_views(dev, dtype, lower, unit, trans):
    """T and B as row-strided views of larger buffers (no copy is made),
    n and nrhs ragged against the block step and the column tile."""
    n, nrhs = 261, TILE + 5
    rng = np.random.default_rng(31 + 2 * lower + unit + 4 * trans)
    t = _tri(rng, n, dtype, lower != trans, unit)
    tbig = _rand(rng, n + 3, n + 9, dtype)
    tbig[3:, 7:7 + n] = t
    bbig = _rand(rng, n + 2, nrhs + 11, dtype)
    _, tb = _both(tbig, dev)
    b_cpu, bb = _both(bbig, dev)
    tv, bv = tb[3:, 7:7 + n], bb[2:, 5:5 + nrhs]
    assert tv.stride(0) == n + 9 and bv.stride(0) == nrhs + 11
    got = _trsm(tv, bv, lower, unit, trans).cpu().numpy()
    ref = pk.trsm_plain(torch.from_numpy(t), b_cpu[2:, 5:5 + nrhs], lower, unit, trans).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype, n, ref))
    assert pk.LAUNCHES["trsm_lower" if lower else "trsm_upper"] == pk.trsm_kernel_launches(n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,nrhs", [(KB + 1, 3), (1000, 1), (1000, "tile+1")])
def test_trsm_lu_modes_ignore_the_other_factor(dev, dtype, n, nrhs):
    """Packed LU storage, randn junk in the other factor's place: the unit
    lower solve and the upper solve equal the solves of the clean
    triangles bit for bit."""
    nrhs = TILE + 1 if nrhs == "tile+1" else nrhs
    rng = np.random.default_rng(n + 5)
    low = _tri(rng, n, dtype, True, True)
    up = _tri(rng, n, dtype, False, False)
    _, p = _both(np.tril(low, -1) + np.triu(up), dev)
    _, lo = _both(low, dev)
    _, u = _both(up, dev)
    _, b = _both(_rand(rng, n, nrhs, dtype), dev)
    y = pk.trsm_lower(p, b, unit=True)
    assert torch.equal(y, pk.trsm_lower(lo, b, unit=True))
    x = pk.trsm_upper(p, y)
    assert torch.equal(x, pk.trsm_upper(u, y))
    ref = pk.trsm_plain(u, pk.trsm_plain(lo, b, True, unit=True), False).cpu().numpy()
    np.testing.assert_allclose(x.cpu().numpy(), ref, rtol=0, atol=_tol(dtype, n, ref))
    assert pk.LAUNCHES["trsm_lower"] == pk.LAUNCHES["trsm_upper"] == 2 * pk.trsm_kernel_launches(n)


@pytest.mark.cuda
def test_potrs_from_global_on_an_ill_conditioned_factor(dev):
    """The real Cholesky factor of an SPD matrix with condition number
    1e8, solved through both sweeps of the kernel pair: the scaled
    residual ||A X - B||_1 / (||A||_1 ||X||_1 n eps) stays <= 3."""
    import slate_tpu_torch as stt

    n, nrhs = 1000, 5
    rng = np.random.default_rng(9)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.logspace(0, -8, n)) @ q.T
    a = (a + a.T) / 2
    b = rng.standard_normal((n, nrhs))
    _, A = _both(a, dev)
    _, B = _both(b, dev)
    X = stt.potrs_from_global(torch.linalg.cholesky(A), B, "pallas")
    launches = pk.trsm_kernel_launches(n, nrhs)
    assert pk.LAUNCHES["trsm_lower"] == launches and pk.LAUNCHES["trsm_upper"] == launches
    x = X.cpu().numpy()
    n1 = lambda m: np.abs(m).sum(0).max()  # noqa: E731
    res = n1(a @ x - b) / (n1(a) * n1(x) * n * np.finfo(np.float64).eps)
    assert res <= 3


@pytest.mark.cuda
def test_wrappers_raise_on_unsupported(dev):
    z = torch.zeros(8, 8, dtype=torch.complex128, device=dev)
    with pytest.raises(TypeError):
        pk.gemm_sub(z, z, z)
    h = torch.zeros(8, 8, dtype=torch.float16, device=dev)
    with pytest.raises(TypeError):
        pk.syrk_diag(h, h)
    x = torch.zeros(8, 8, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        pk.trsm_lower(x, x.T)  # inner stride != 1
    with pytest.raises(ValueError):
        pk.gemm_sub(x, x[:1].expand(8, 8), x)  # row stride 0: rows overlap
    with pytest.raises(ValueError):
        pk.gemm_sub(x, x, x.cpu())  # mixed devices
    assert all(v == 0 for v in pk.LAUNCHES.values())


@pytest.mark.cuda
def test_posv_on_the_card_takes_the_kernels(dev):
    import slate_tpu_torch as stt
    from slate_tpu_torch.ops import chol_kernels as ck

    n, nrhs = 2100, 3  # Schedule.Auto takes the kernels at n >= 2048; 2100 pads
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, n))
    a = a @ a.T + n * np.eye(n)
    b = rng.standard_normal((n, nrhs))
    grid = stt.ProcessGrid.single()
    X, L, info = stt.posv(stt.HermitianMatrix.from_global(a, 256, grid=grid),
                          stt.Matrix.from_global(b, 256, grid=grid))
    assert int(info) == 0
    got = {k: pk.LAUNCHES[k] for k in ("chol_base", "syrk_diag", "gemm_sub")}
    assert got == ck.chol_kernel_launches(n)
    x = X.to_global().cpu().numpy()
    res = np.abs(a @ x - b).max() / (np.abs(a).max() * np.abs(x).max() * n)
    assert res <= 3 * np.finfo(np.float64).eps
    Y = stt.potrs_from_global(L.to_global(), torch.from_numpy(b).to(dev))
    launches = pk.trsm_kernel_launches(n, nrhs)
    assert pk.LAUNCHES["trsm_lower"] == launches and pk.LAUNCHES["trsm_upper"] == launches
    np.testing.assert_allclose(Y.cpu().numpy(), x, rtol=0, atol=_tol(np.float64, n, x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_gemm_sub_large_tiles_ragged(dev, dtype):
    """An output of 13 x 13 tiles of 128, with ragged edges on every side
    and rows at odd offsets (the 128 x 128 tile variant runs where it
    fills the card: float64)."""
    rng = np.random.default_rng(23)
    M, N, K = 1601, 1550, 333
    c_cpu, c = _both(_rand(rng, M + 3, N + 5, dtype), dev)
    a_cpu, a = _both(_rand(rng, M, K + 7, dtype), dev)
    b_cpu, b = _both(_rand(rng, N, K + 1, dtype), dev)
    got = pk.gemm_sub(c[3:, 5:], a[:, 7:], b[:, 1:]).cpu().numpy()
    ref = pk.gemm_sub(c_cpu[3:, 5:], a_cpu[:, 7:], b_cpu[:, 1:]).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype, K, ref))


def _view(rng, rows, cols, dtype, dev, aligned):
    """A (rows, cols) view into a larger row-major matrix: rows start
    16-byte aligned (``aligned``: a row stride that is a multiple of 4
    values, so the staging copies 16 bytes at once and a ragged K reads
    a partial vector) or not (one column in: one copy a value)."""
    ld = -(-cols // 4) * 4 + (0 if aligned else 4)
    x = _rand(rng, rows, ld, dtype)
    off = 0 if aligned else 1
    cpu, d = _both(x, dev)
    return cpu[:, off:off + cols], d[:, off:off + cols]


def _fill_cols(dtype, dev):
    """Tile columns of 128 that make one row of tiles fill the card (the
    128 x 128 variant's slots, as the built kernel reports them)."""
    pk._load()
    big = pk._GEMM_TILES[getattr(torch, np.dtype(dtype).name)][0]
    return -(-9 * big.per_sm * pk._sms(dev) // 10), big.bm


# (M, N, K, the tile variant, whether K is split): M or N at tile - 1,
# tile, tile + 1 of both variants ("fill": as many columns as fill the
# card), K not a multiple of the slice, K under one slice, and the split
# at a 256 x 256 output with K = 8192
GEMM_SEAMS = [(e, "fill", 40, 0, False) for e in (127, 128, 129)] + \
    [("fill", e, 37, 0, False) for e in (127, 128, 129)] + \
    [(e, e, 300, 1, None) for e in (63, 64, 65)] + \
    [(200, 190, 1003, 1, None), (70, 50, 3, 1, False), (256, 256, 8192, None, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("M,N,K,variant,split", GEMM_SEAMS)
def test_gemm_sub_seams(dev, dtype, aligned, M, N, K, variant, split):
    """gemm_sub across the seams of its tiles and its K ring, against the
    plain version on the card, on views with aligned and unaligned rows;
    two calls give bitwise equal results."""
    cols, bm = _fill_cols(dtype, dev)
    M = cols * bm - 3 if M == "fill" else M
    N = cols * bm - 3 if N == "fill" else N
    rng = np.random.default_rng(M + 3 * N + K)
    _, c = _view(rng, M, N, dtype, dev, aligned)
    _, a = _view(rng, M, K, dtype, dev, aligned)
    _, b = _view(rng, N, K, dtype, dev, aligned)
    plan = pk._gemm_plan(c, M, N, K, False)
    if variant is not None:
        assert plan.variant == variant
    if split is not None:
        assert (plan.ksplit > 1) == split
    got = pk.gemm_sub(c, a, b)
    again = pk.gemm_sub(c, a, b)
    assert pk.LAUNCHES["gemm_sub"] == 2
    assert torch.equal(got, again)  # fixed order, no atomics
    ref = pk.gemm_sub_plain(c, a, b).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=0, atol=_tol(dtype, K, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("t,K", [(256, 4096), (256, 8192), (129, 37), (64, 1), (65, 300)])
def test_syrk_diag_seams(dev, dtype, aligned, t, K):
    """syrk_diag at the main path's t = 256 (K split) and across the tile
    seams: the strict upper triangle is bitwise untouched, the lower one
    agrees with the plain version, and two calls are bitwise equal."""
    rng = np.random.default_rng(t + K)
    _, c = _view(rng, t, t, dtype, dev, aligned)
    _, a = _view(rng, t, K, dtype, dev, aligned)
    got = pk.syrk_diag(c, a)
    assert torch.equal(got, pk.syrk_diag(c, a))
    assert pk.LAUNCHES["syrk_diag"] == 2
    assert torch.equal(torch.triu(got, 1), torch.triu(c, 1))
    if K >= 4096:
        assert pk._gemm_plan(c, t, t, K, True).ksplit > 1
    ref = pk.syrk_diag_plain(c, a).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=0, atol=_tol(dtype, K, ref))


@pytest.mark.cuda
def test_gemm_layout_is_the_plans(dev):
    """The tiles the built kernel reports are the ones the plan reads."""
    pk._load()
    for dt in (torch.float32, torch.float64):
        tiles = pk._GEMM_TILES[dt]
        assert len(tiles) == 2 and tiles[0].bm > tiles[1].bm and tiles[-1].per_sm >= 1
        for M, N, K in [(4096, 4096, 8192), (256, 256, 8192), (70, 50, 3)]:
            x = torch.empty(0, dtype=dt, device=dev)
            plan = pk._gemm_plan(x, M, N, K, False)
            assert plan == pk.gemm_sub_plan(M, N, K, False, tiles, pk._sms(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,nb,act,pivot", [
    (1000, 77, None, True), (1000, 77, 900, True), (300, 64, None, False), (40, 90, None, True),
])
def test_panel_lu_matches_plain(dev, dtype, m, nb, act, pivot):
    """The kernel is bit-identical to its plain version on the card (no
    FMA contraction, IEEE division); the panel is a strided view."""
    rng = np.random.default_rng(m + nb)
    big = rng.standard_normal((m, nb + 9))
    if not pivot:
        big[:, 5:5 + nb] += m * np.eye(m, nb)
    if act is not None:
        big[act:] = 0.0  # the recursion's canonical pad: exact zero rows
    _, big_dev = _both(big.astype(dtype), dev)
    view = big_dev[:, 5:5 + nb]
    lu, perm = pk.panel_lu(view, pivot=pivot, act=act)
    assert pk.LAUNCHES["panel_lu"] == 1 and perm.dtype == torch.int32
    ref_lu, ref_perm = pk.panel_lu_plain(view, pivot, act)
    assert torch.equal(perm, ref_perm)
    assert torch.equal(lu, ref_lu)
    cpu_lu, cpu_perm = pk.panel_lu_plain(view.cpu(), pivot, act)
    np.testing.assert_array_equal(perm.cpu().numpy(), cpu_perm.numpy())
    np.testing.assert_allclose(lu.cpu().numpy(), cpu_lu.numpy(), rtol=0,
                               atol=_tol(dtype, nb, cpu_lu.numpy()))
    if act is not None:
        np.testing.assert_array_equal(perm[act:].cpu().numpy(), np.arange(act, m))


@pytest.mark.cuda
def test_panel_lu_ties_and_zero_column(dev):
    rng = np.random.default_rng(5)
    P = rng.standard_normal((500, 32))
    P[:, 0] = np.where(P[:, 0] > 0, 1.0, -1.0)  # ties: the first row wins
    P[:, 7] = 0.0  # a zero pivot column: zero multipliers, no NaN
    _, Pd = _both(P, dev)
    lu, perm = pk.panel_lu(Pd)
    ref_lu, ref_perm = pk.panel_lu_plain(Pd)
    assert int(perm[0]) == 0 and torch.equal(perm, ref_perm) and torch.equal(lu, ref_lu)
    assert bool(torch.isfinite(lu).all()) and not bool(lu[8:, 7].any())


@pytest.mark.cuda
@pytest.mark.parametrize("m,nb,act,pivot,dtype", [
    (2000, 31, None, True, np.float64),     # one strip, narrower than 32
    (2000, 33, None, True, np.float32),     # a last strip of one column
    (3000, 65, None, True, np.float64),     # two whole strips and one column
    (3000, 65, 66, True, np.float32),       # act: one row to spare at the last column
    (5000, 100, 2500, True, np.float64),    # act inside a block's rows
    (262144, 64, None, True, np.float64),   # a tall panel: the plan's strip is < 32
    (4096, 256, None, False, np.float64),   # no exchanges (the RBT route)
    (4096, 256, None, False, np.float32),
    (70, 200, None, True, np.float64),      # M < nb: a barrier of its own after the last strip
])
def test_panel_lu_strip_seams(dev, m, nb, act, pivot, dtype):
    """The strip schedule at its seams is bit-identical to the plain
    version."""
    rng = np.random.default_rng(m + nb)
    a = rng.standard_normal((m, nb))
    if not pivot:
        a += m * np.eye(m, nb)
    if act is not None:
        a[act:] = 0.0
    _, P = _both(a.astype(dtype), dev)
    plan = pk._panel_lu_plan(P)
    if m == 262144:
        assert plan.strip < 32
    lu, perm = pk.panel_lu(P, pivot=pivot, act=act)
    assert pk.LAUNCHES["panel_lu"] == 1
    ref_lu, ref_perm = pk.panel_lu_plain(P, pivot, act)
    assert torch.equal(perm, ref_perm) and torch.equal(lu, ref_lu), plan


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_panel_lu_nan_and_inf(dev, dtype):
    """A NaN and an inf spread into the finished rows as the plain
    version's updates spread them: NaN in the same places, every other
    value equal."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((3000, 96))
    a[1000, 5], a[1500, 70] = np.nan, np.inf
    _, P = _both(a.astype(dtype), dev)
    lu, perm = pk.panel_lu(P)
    ref_lu, ref_perm = pk.panel_lu_plain(P)
    nan = ref_lu.isnan()
    assert bool(nan.any()) and torch.equal(perm, ref_perm) and torch.equal(lu.isnan(), nan)
    assert torch.equal(lu.masked_fill(nan, 0), ref_lu.masked_fill(nan, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("n2,w,h", [(256, 7, 128), (256, 7, 32), (64, 1, 2)])
def test_butterfly_level_matches_plain(dev, dtype, transpose, n2, w, h):
    rng = np.random.default_rng(n2 + w + h)
    _, big = _both(rng.standard_normal((n2, w + 3)).astype(dtype), dev)
    _, D = _both(np.exp(rng.uniform(-0.1, 0.1, n2)).astype(dtype), dev)
    X = big[:, 3:]  # a strided view
    got = pk.butterfly_level(X, D, h, transpose)
    assert pk.LAUNCHES["butterfly_level"] == 1
    assert torch.equal(got, pk.butterfly_level_plain(X, D, h, transpose))


@pytest.mark.cuda
def test_lu_wrappers_raise_on_unsupported(dev):
    z = torch.zeros(8, 8, dtype=torch.complex128, device=dev)
    with pytest.raises(TypeError):
        pk.panel_lu(z)
    x = torch.zeros(8, 8, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        pk.butterfly_level(x.T, x[0], 4, True)  # inner stride != 1
    with pytest.raises(ValueError):
        pk.panel_lu(x.T)
    assert all(v == 0 for v in pk.LAUNCHES.values())


@pytest.mark.cuda
def test_gesv_on_the_card_takes_the_kernels(dev):
    import slate_tpu_torch as stt
    from slate_tpu_torch.ops import lu_kernels as lk

    n, nrhs = 2100, 3  # Schedule.Auto takes the kernels at n >= 2048; 2100 pads to 2304
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((n, n)), rng.standard_normal((n, nrhs))
    grid = stt.ProcessGrid.single()
    A, B = stt.Matrix.from_global(a, 256, grid=grid), stt.Matrix.from_global(b, 256, grid=grid)
    X, LU, piv, info = stt.gesv(A, B)
    assert int(info) == 0
    assert pk.LAUNCHES["panel_lu"] == lk.getrf_kernel_launches(2304)
    x = X.to_global().cpu().numpy()
    res = np.abs(a @ x - b).max() / (np.abs(a).max() * np.abs(x).max() * n)
    assert res <= 3 * np.finfo(np.float64).eps
    pk.reset_launches()
    Y = stt.getrs_from_global(LU.to_global(), piv.apply(torch.from_numpy(b).to(dev)))
    launches = pk.trsm_kernel_launches(n, nrhs)
    assert pk.LAUNCHES["trsm_lower"] == launches and pk.LAUNCHES["trsm_upper"] == launches
    np.testing.assert_allclose(Y.cpu().numpy(), x, rtol=0, atol=_tol(np.float64, n, x) * 10)
    pk.reset_launches()
    Xr, _, _, info = stt.gesv(A, B, {stt.Option.MethodLU: stt.MethodLU.RBT})
    assert int(info) == 0 and pk.LAUNCHES["butterfly_level"] == 16
    xr = Xr.to_global().cpu().numpy()
    res = np.abs(a @ xr - b).max() / (np.abs(a).max() * np.abs(xr).max() * n)
    assert res <= 1000 * np.finfo(np.float64).eps


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,lookahead,pivot", [(1200, 700, 2, True), (640, 640, 1, False)])
def test_getrf_recursive_families_agree_on_the_card(dev, m, n, lookahead, pivot):
    """Tall, with a peeled panel, and without pivoting: the kernel family
    and the plain family run the same arithmetic, so LU and perm agree
    bit for bit on the card."""
    from slate_tpu_torch.ops import lu_kernels as lk

    rng = np.random.default_rng(m + n)
    a = rng.standard_normal((m, n)) + (0 if pivot else m * np.eye(m, n))
    _, A = _both(a, dev)
    lu_k, p_k = lk.getrf_recursive(A, 128, lookahead, "pallas", pivot=pivot)
    assert pk.LAUNCHES["panel_lu"] == lk.getrf_kernel_launches(n, 128, lookahead)
    lu_r, p_r = lk.getrf_recursive(A, 128, lookahead, "recursive", pivot=pivot)
    assert torch.equal(p_k, p_r) and torch.equal(lu_k, lu_r)
    lu = lu_k.cpu().numpy()
    L, U = np.tril(lu, -1)[:, :n] + np.eye(m, n), np.triu(lu[:n])
    np.testing.assert_allclose(L @ U, a[p_k.cpu().numpy()], rtol=0, atol=_tol(np.float64, n, a))


def _consistent_v(rng, m, w, dtype):
    """Unit-lower V with a small strict lower part and tau = 2 / ||v||^2
    (exact reflectors), so T^-1 stays well conditioned."""
    V = np.tril(rng.standard_normal((m, w)), -1) * 0.1 + np.eye(m, w)
    sq = (V * V).sum(0)  # 0 for the columns past a short V's rows: no reflector
    return V.astype(dtype), np.where(sq > 0, 2.0 / np.where(sq > 0, sq, 1), 0).astype(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,w,strided", [(1, 1, False), (5, 1, False), (700, 200, True),
                                         (3000, 256, False), (40, 64, True),
                                         (24576, 256, False), (3000, 256, True),
                                         (1500, 1024, False), (1500, 1024, True)])
def test_larft_matches_plain(dev, dtype, m, w, strided):
    """T^-1: diagonal bitwise, lower triangle exactly zero, the strict
    upper Gram within tolerance, two calls bitwise equal; T through the
    library solve agrees.  A strided V is a view at column offset 5 (rows
    not 16-byte aligned: the kernel's one-value copies)."""
    rng = np.random.default_rng(m + w)
    V, taus = _consistent_v(rng, m, w, dtype)
    if w > 2:
        taus[w // 2] = 0.0  # an absent reflector
    big = np.zeros((m, w + 5), dtype)
    big[:, 5:] = V
    _, big_dev = _both(big, dev)
    Vd = big_dev[:, 5:] if strided else big_dev[:, 5:].contiguous()
    short = w - 1 if w > 1 else w  # a short taus vector: the last reflector absent
    _, td = _both(taus[:short], dev)
    got = pk.larft_tinv(Vd, td)
    assert pk.LAUNCHES["larft"] == 1
    assert torch.equal(pk.larft_tinv(Vd, td), got)  # chunk order, not arrival order
    ref = pk.larft_tinv_plain(Vd, td)
    assert torch.equal(got.diagonal(), ref.diagonal())
    assert not bool(torch.tril(got, -1).any())
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=_tol(dtype, m, ref.cpu().numpy()))
    T = pk.larft(Vd, td).cpu().numpy()
    Tp = pk.larft_plain(Vd, td).cpu().numpy()
    dead = np.flatnonzero(np.r_[taus[:short], np.zeros(w - short)] == 0)
    assert np.isfinite(T).all() and not T[dead].any() and not T[:, dead].any()
    np.testing.assert_allclose(T, Tp, rtol=0, atol=_tol(dtype, m, Tp))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,w", [(2000, 256), (333, 100)])
def test_larft_on_an_aligned_view(dev, dtype, m, w):
    """A view at column offset 4 of rows of w + 8 values (16-byte
    aligned: the kernel's 16-byte copies, cut at the last column)."""
    rng = np.random.default_rng(m * w)
    V, taus = _consistent_v(rng, m, w, dtype)
    big = np.zeros((m, w + 8), dtype)
    big[:, 4:4 + w] = V
    _, big_dev = _both(big, dev)
    _, td = _both(taus, dev)
    Vd = big_dev[:, 4:4 + w]
    got = pk.larft_tinv(Vd, td)
    ref = pk.larft_tinv_plain(Vd, td)
    assert torch.equal(got.diagonal(), ref.diagonal())
    assert not bool(torch.tril(got, -1).any())
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=_tol(dtype, m, ref.cpu().numpy()))


@pytest.mark.cuda
def test_larft_layout_is_the_plans(dev):
    """The tiles the built larft kernel reports are the ones the plan
    reads; at the gels main path's heights its blocks fill one wave, to
    within a chunk of each of the 3 tiles."""
    pk._load()
    for dt in (torch.float32, torch.float64):
        tiles = pk._LARFT_TILES[dt]
        assert len(tiles) == 2 and tiles[0].bm > tiles[1].bm and tiles[-1].per_sm >= 1
        slots = tiles[0].per_sm * pk._sms(dev)
        for M in (32768, 24576):
            plan = pk.larft_plan(M, 256, tiles, pk._sms(dev))
            assert plan.variant == 0
            assert slots - 3 < pk.larft_blocks(plan, 256, tiles[0].bm) <= slots


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,mb,nb", [(1, 1, 1), (1, 37, 29), (7, 33, 100), (3, 512, 40)])
def test_tile_norms_matches_plain(dev, dtype, N, mb, nb):
    rng = np.random.default_rng(N + mb + nb)
    _, big = _both(rng.standard_normal((N, mb, nb + 3)).astype(dtype), dev)
    T = big[:, :, 3:]  # a strided stack
    for kind in ("max", "fro_sumsq", "one", "inf"):
        got = pk.tile_norms(T, kind)
        ref = pk.tile_norms_plain(T, kind)
        assert got.shape == ref.shape
        if kind == "max":
            assert torch.equal(got, ref)
        else:
            k = {"fro_sumsq": mb * nb, "one": mb, "inf": nb}[kind]
            r = ref.cpu().numpy()
            np.testing.assert_allclose(got.cpu().numpy(), r, rtol=0, atol=_tol(dtype, k, r))
    assert pk.LAUNCHES["tile_norms"] == 4
    T2 = T.clone()
    T2[N - 1, mb // 2, nb // 2] = float("nan")
    for kind in ("max", "fro_sumsq", "one", "inf"):
        out = pk.tile_norms(T2, kind).reshape(N, -1)
        assert bool(torch.isnan(out[N - 1]).any())
        assert bool(torch.isfinite(out[: N - 1]).all())


def _counted_stack(dev, dtype, P, Q, mb, nb, off, seed):
    """A (P Q, mb, nb) stack on the card, a view at column offset ``off``
    of a wider one, with ragged counts (tile 0 whole) and NaN in the
    padding beyond them; returns (stack, rows, cols)."""
    rng = np.random.default_rng(seed)
    big = torch.from_numpy(rng.standard_normal((P * Q, mb, nb + off)).astype(dtype)).to(dev)
    T = big[:, :, off:]
    rows = rng.integers(0, mb + 1, P).astype(np.int32)
    cols = rng.integers(0, nb + 1, Q).astype(np.int32)
    rows[0], cols[0] = mb, nb
    rows, cols = torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev)
    rm = torch.arange(mb, device=dev) < rows[:, None]
    cm = torch.arange(nb, device=dev) < cols[:, None]
    mask = (rm[:, None, :, None] & cm[None, :, None, :]).reshape(P * Q, mb, nb)
    T.masked_fill_(~mask, float("nan"))
    return T, rows, cols


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P,Q,mb,nb,off", [(3, 4, 64, 64, 0), (2, 3, 37, 29, 0),
                                           (4, 4, 512, 40, 3), (2, 2, 33, 100, 3),
                                           (2, 2, 16, 128, 4), (1, 2, 9, 1030, 0)])
def test_tile_norms_counts_scale_skip(dev, dtype, P, Q, mb, nb, off):
    """The counts, max_sumsq, fro_sumsq's scale and skip against the
    plain version, on the 16-byte path and the one-value path (odd nb, a
    view at column offset 3); NaN in the padding reaches no output; two
    calls bitwise equal."""
    T, rows, cols = _counted_stack(dev, dtype, P, Q, mb, nb, off, P * mb + nb + off)
    esz = np.dtype(dtype).itemsize
    vector = (off * esz) % 16 == 0 and ((nb + off) * esz) % 16 == 0
    assert pk._vector_aligned(esz, T.data_ptr(), T.stride(0), T.stride(1)) == vector
    k = {"max": 1, "fro_sumsq": mb * nb, "max_sumsq": mb * nb, "one": mb, "inf": nb}
    for kind in ("max", "fro_sumsq", "one", "inf", "max_sumsq"):
        got = pk.tile_norms(T, kind, rows, cols)
        ref = pk.tile_norms_plain(T, kind, rows, cols)
        assert got.shape == ref.shape and bool(torch.isfinite(got).all()), kind
        assert torch.equal(pk.tile_norms(T, kind, rows, cols), got), f"{kind}: two calls differ"
        if kind in ("max", "max_sumsq"):
            assert torch.equal(got if kind == "max" else got[:, 0],
                               ref if kind == "max" else ref[:, 0]), kind
        r = ref.cpu().numpy()
        np.testing.assert_allclose(got.cpu().numpy(), r, rtol=0, atol=_tol(dtype, k[kind], r))
    scale = pk.tile_norms_plain(T, "max", rows, cols).amax() * 1.5
    got = pk.tile_norms(T, "fro_sumsq", rows, cols, scale=scale)
    r = pk.tile_norms_plain(T, "fro_sumsq", rows, cols, scale=scale).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), r, rtol=0, atol=_tol(dtype, mb * nb, r))
    no, yes = torch.tensor(False, device=dev), torch.tensor(True, device=dev)
    assert torch.equal(pk.tile_norms(T, "fro_sumsq", rows, cols, scale=scale, skip=no), got)
    assert not bool(pk.tile_norms(T, "fro_sumsq", rows, cols, scale=scale, skip=yes).any())
    assert pk.LAUNCHES["tile_norms"] == 13


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_norms_vector_and_one_value_paths_agree(dev, dtype):
    """The same tiles read in 16-byte vectors and a value at a time (a
    copy at column offset 3) give bitwise equal maxima and sums within
    tolerance of each other."""
    rng = np.random.default_rng(12)
    _, A = _both(rng.standard_normal((8, 96, 128)).astype(dtype), dev)
    big = torch.zeros(8, 96, 131, dtype=A.dtype, device=dev)
    B = big[:, :, 3:]
    B.copy_(A)
    assert pk._vector_aligned(A.element_size(), A.data_ptr(), A.stride(0), A.stride(1))
    assert not pk._vector_aligned(B.element_size(), B.data_ptr(), B.stride(0), B.stride(1))
    for kind, k in (("max", 1), ("fro_sumsq", 96 * 128), ("one", 96), ("inf", 128),
                    ("max_sumsq", 96 * 128)):
        a, b = pk.tile_norms(A, kind), pk.tile_norms(B, kind)
        if kind == "max":
            assert torch.equal(a, b)
        r = a.cpu().numpy()
        np.testing.assert_allclose(b.cpu().numpy(), r, rtol=0, atol=_tol(dtype, k, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,mb,nb", [(1, 1, 1), (5, 33, 70), (2, 64, 64)])
def test_tile_geadd_and_transpose_bitwise(dev, dtype, N, mb, nb):
    rng = np.random.default_rng(N * mb + nb)
    _, big = _both(rng.standard_normal((N, mb + 2, nb + 1)).astype(dtype), dev)
    _, B = _both(rng.standard_normal((N, mb, nb)).astype(dtype), dev)
    A = big[:, 2:, 1:]
    for alpha, beta in ((0.3, -1.7), (1.0, 0.0), (-2.5, 1.0)):
        assert torch.equal(pk.tile_geadd(alpha, A, beta, B), pk.tile_geadd_plain(alpha, A, beta, B))
    got = pk.tile_transpose(A)
    assert got.shape == (N, nb, mb) and got.is_contiguous()
    assert torch.equal(got, pk.tile_transpose_plain(A))
    assert pk.LAUNCHES["tile_geadd"] == 3 and pk.LAUNCHES["tile_transpose"] == 1


@pytest.mark.cuda
def test_qr_and_tile_wrappers_raise_on_unsupported(dev):
    z = torch.zeros(8, 8, dtype=torch.complex128, device=dev)
    with pytest.raises(TypeError):
        pk.larft_tinv(z, z[0])
    with pytest.raises(TypeError):
        pk.tile_norms(z.reshape(1, 8, 8), "max")
    x = torch.zeros(8, 8, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        pk.larft_tinv(x.T, x[0])  # inner stride != 1
    s = torch.zeros(2, 8, 8, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        pk.tile_norms(s.transpose(1, 2), "one")
    counts = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError):  # counts on the host
        pk.tile_norms(s, "one", rows=counts, cols=torch.tensor([8, 8], dtype=torch.int32))
    with pytest.raises(ValueError):  # 1 x 1 counts for 2 tiles
        pk.tile_norms(s, "one", rows=counts.to(dev), cols=counts.to(dev))
    with pytest.raises(ValueError):
        pk.tile_transpose(s.transpose(1, 2))
    with pytest.raises(ValueError):
        pk.tile_geadd(1.0, s, 1.0, s[:, :, :1].expand(2, 8, 8))  # overlapping rows
    assert all(v == 0 for v in pk.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["auto", "pallas"])
def test_gels_on_the_card(dev, schedule):
    """(2100, 1500) pads to (2304, 1536): auto takes the flat schedule,
    explicit pallas the recursion with the larft kernel."""
    import slate_tpu_torch as stt
    from slate_tpu_torch.ops import qr_fast

    m, n, nrhs = 2100, 1500, 3
    rng = np.random.default_rng(6)
    a, b = rng.standard_normal((m, n)), rng.standard_normal((m, nrhs))
    grid = stt.ProcessGrid.single()
    X = stt.gels(stt.Matrix.from_global(a, 256, grid=grid),
                 stt.Matrix.from_global(b, 256, grid=grid), {stt.Option.Schedule: schedule})
    expect = qr_fast.geqrf_kernel_launches(1536, 256) if schedule == "pallas" else 0
    assert pk.LAUNCHES["larft"] == expect
    x = X.to_global().cpu().numpy()
    ref = torch.linalg.lstsq(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
                             ).solution.cpu().numpy()
    np.testing.assert_allclose(x, ref, rtol=0, atol=1e-10 * max(np.abs(ref).max(), 1.0))


@pytest.mark.cuda
def test_norm_on_the_card_launches_tile_norms(dev):
    import slate_tpu_torch as stt

    rng = np.random.default_rng(8)
    a = rng.standard_normal((1000, 700))
    A = stt.Matrix.from_global(a, 128, grid=stt.ProcessGrid.single())
    refs = {"One": np.abs(a).sum(0).max(), "Inf": np.abs(a).sum(1).max(),
            "Max": np.abs(a).max(), "Fro": np.sqrt((a * a).sum())}
    for name, ref in refs.items():
        pk.reset_launches()
        got = float(stt.norm(stt.Norm[name], A))
        assert pk.LAUNCHES["tile_norms"] == (2 if name == "Fro" else 1)
        assert abs(got - ref) <= 1e-12 * ref
    # NaN in the padding reaches no norm
    A.data[~A.layout.element_mask(dev)] = float("nan")
    for name, ref in refs.items():
        assert abs(float(stt.norm(stt.Norm[name], A)) - ref) <= 1e-12 * ref
    # a transposed view (its resolved storage lies transposed in memory)
    got = float(stt.norm(stt.Norm.One, stt.conj_transpose(A)))
    assert abs(got - refs["Inf"]) <= 1e-12 * refs["Inf"]
    # Fro on data that takes the scaled pass (the unscaled sum would
    # overflow or underflow), still two launches
    for c in (1e300, 1e-160):
        pk.reset_launches()
        got = float(stt.norm(stt.Norm.Fro, stt.Matrix.from_global(a * c, 128,
                                                                  grid=stt.ProcessGrid.single())))
        assert pk.LAUNCHES["tile_norms"] == 2
        assert abs(got - refs["Fro"] * c) <= 1e-12 * refs["Fro"] * c


def _scaled_residual(a, x, b):
    """||A X - B||_1 / (||A||_1 ||X||_1 n eps) (PERF.md section 2)."""
    n1 = lambda m: np.abs(m).sum(axis=0).max()  # noqa: E731
    return n1(a @ x - b) / (n1(a) * n1(x) * a.shape[0] * np.finfo(np.float64).eps)


@pytest.mark.cuda
def test_complex_drivers_on_the_card_take_no_kernel(dev):
    """complex128 at n = 2048 with default options: the kernels take only
    float32/float64, so the resolvers route the factorizations to the
    recursive schedule and the solve phases to the library solve; every
    residual is inside PERF.md section 2's bound and no kernel launches
    (the wrappers still raise for a complex tensor:
    test_wrappers_raise_on_unsupported)."""
    import slate_tpu_torch as stt

    n, nrhs = 2048, 3
    rng = np.random.default_rng(11)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    b = rng.standard_normal((n, nrhs)) + 1j * rng.standard_normal((n, nrhs))
    s = a @ a.conj().T + n * np.eye(n)
    grid = stt.ProcessGrid.single()
    M = lambda x: stt.Matrix.from_global(x, 256, grid=grid)  # noqa: E731
    X, L, info = stt.posv(stt.HermitianMatrix.from_global(s, 256, grid=grid), M(b))
    assert int(info) == 0 and _scaled_residual(s, X.to_global().cpu().numpy(), b) <= 3
    Y = stt.potrs_from_global(L.to_global(), torch.from_numpy(b).to(dev))
    assert _scaled_residual(s, Y.cpu().numpy(), b) <= 3
    X, LU, piv, info = stt.gesv(M(a), M(b))
    assert int(info) == 0 and _scaled_residual(a, X.to_global().cpu().numpy(), b) <= 3
    Y = stt.getrs_from_global(LU.to_global(), piv.apply(torch.from_numpy(b).to(dev)))
    assert _scaled_residual(a, Y.cpu().numpy(), b) <= 3
    X, _, _, info = stt.gesv(M(a), M(b), {stt.Option.MethodLU: stt.MethodLU.RBT})
    assert int(info) == 0 and _scaled_residual(a, X.to_global().cpu().numpy(), b) <= 1000
    t = np.vstack([a, rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))])
    bt = rng.standard_normal((2 * n, nrhs)) + 1j * rng.standard_normal((2 * n, nrhs))
    x = stt.gels(M(t), M(bt)).to_global().cpu().numpy()
    n1 = lambda m: np.abs(m).sum(axis=0).max()  # noqa: E731
    ls = n1(t.conj().T @ (t @ x - bt)) / (
        n1(t) * (n1(t) * n1(x) + n1(bt)) * 2 * n * np.finfo(np.float64).eps)
    assert ls <= 3
    assert all(v == 0 for v in pk.LAUNCHES.values())
