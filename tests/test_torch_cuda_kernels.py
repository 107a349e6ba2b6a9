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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_calu_kernel_route_matches_plain_route(dev, dtype):
    """Tournament pivoting at n = 2100 in tiles of 256 (padded to 2304,
    rows to 3072: three chunks, an odd bracket count): the panel_lu
    kernel route and the plain-panel route give the same perm and LU bit
    for bit, with ``tntpiv_kernel_launches`` launches; gesv with
    MethodLU.CALU solves within the JAX package's CALU bound (100)."""
    import slate_tpu_torch as stt
    from slate_tpu_torch.drivers.lu import _padded_global
    from slate_tpu_torch.ops import lu_kernels as lk

    n, nb, nrhs = 2100, 256, 3
    rng = np.random.default_rng(23)
    a, b = _rand(rng, n, n, dtype), _rand(rng, n, nrhs, dtype)
    grid = stt.ProcessGrid.single()
    Am = stt.Matrix.from_global(a, nb, grid=grid)
    Gp = _padded_global(Am)
    lu_k, p_k = lk.blocked_getrf_tntpiv(Gp, nb, panel_fn=pk.panel_lu)
    launches = pk.LAUNCHES["panel_lu"]
    lu_p, p_p = lk.blocked_getrf_tntpiv(Gp, nb, panel_fn=pk.panel_lu_plain)
    assert launches == lk.tntpiv_kernel_launches(*Gp.shape, nb) == 9 * 7
    assert pk.LAUNCHES["panel_lu"] == launches
    assert torch.equal(p_k, p_p)
    assert torch.equal(lu_k, lu_p)
    pk.reset_launches()
    X, _, _, info = stt.gesv(Am, stt.Matrix.from_global(b, nb, grid=grid),
                             {stt.Option.MethodLU: stt.MethodLU.CALU})
    assert int(info) == 0 and pk.LAUNCHES["panel_lu"] == 9 * 7
    x = X.to_global().cpu().double().numpy()
    n1 = lambda m: np.abs(m).sum(axis=0).max()  # noqa: E731
    r = n1(a.astype(np.float64) @ x - b) / (n1(a) * n1(x) * n * np.finfo(dtype).eps)
    assert r <= 100, r


@pytest.mark.cuda
def test_complex_calu_on_the_card_takes_no_kernel(dev):
    import slate_tpu_torch as stt

    n, nb = 600, 128
    rng = np.random.default_rng(29)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    b = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    grid = stt.ProcessGrid.single()
    X, _, _, info = stt.gesv(stt.Matrix.from_global(a, nb, grid=grid),
                             stt.Matrix.from_global(b, nb, grid=grid), {"method_lu": "calu"})
    x = X.to_global().cpu().numpy()
    n1 = lambda m: np.abs(m).sum(axis=0).max()  # noqa: E731
    assert int(info) == 0
    assert n1(a @ x - b) / (n1(a) * n1(x) * n * np.finfo(np.float64).eps) <= 100
    assert all(v == 0 for v in pk.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_inverses_and_estimators_on_the_card(dev, dtype):
    """n = 2100: potri and trtri within ||X A - I||_1 / (||A||_1 ||X||_1 n
    eps) <= 3; pocondest, gecondest (One, Inf) and trcondest within
    ref <= rcond <= 3 ref, ref from the float64 inverse."""
    import slate_tpu_torch as stt

    n, nb = 2100, 256
    rng = np.random.default_rng(31)
    g = rng.standard_normal((n, n))
    s = (g @ g.T + n * np.eye(n)).astype(dtype)
    a = (g + np.sqrt(n) * np.eye(n)).astype(dtype)
    grid = stt.ProcessGrid.single()
    eps = np.finfo(dtype).eps
    n1 = lambda m: np.abs(m).sum(axis=0).max()  # noqa: E731
    ninf = lambda m: np.abs(m).sum(axis=1).max()  # noqa: E731

    def inv_residual(x, m):
        x, m = x.astype(np.float64), m.astype(np.float64)
        return n1(x @ m - np.eye(n)) / (n1(m) * n1(x) * n * eps)

    S = stt.HermitianMatrix.from_global(s, nb, grid=grid)
    L, info = stt.potrf(S)
    assert int(info) == 0
    Ainv = stt.potri(L).full_global().cpu().numpy()
    assert inv_residual(Ainv, s) <= 3
    Lg = np.tril(L.to_global().cpu().numpy())
    assert inv_residual(stt.trtri(L).to_global().cpu().numpy(), Lg) <= 3

    def within(rcond, m, inv, norm=n1):
        ref = 1.0 / (norm(m.astype(np.float64)) * norm(inv))
        assert ref * (1 - 1e-3) <= float(rcond) <= 3.0 * ref, (float(rcond), ref)

    s64, a64 = s.astype(np.float64), a.astype(np.float64)
    within(stt.pocondest(L, float(n1(s64))), s64, np.linalg.inv(s64))
    LU, piv, info = stt.getrf(stt.Matrix.from_global(a, nb, grid=grid))
    assert int(info) == 0
    ainv = np.linalg.inv(a64)
    within(stt.gecondest(LU, piv, float(n1(a64))), a64, ainv)
    within(stt.gecondest(LU, piv, float(ninf(a64)), stt.Norm.Inf), a64, ainv, ninf)
    within(stt.trcondest(L), Lg, np.linalg.inv(Lg.astype(np.float64)))
    within(stt.trcondest(stt.conj_transpose(L), stt.Norm.Inf), Lg.T,
           np.linalg.inv(Lg.T.astype(np.float64)), ninf)


@pytest.mark.cuda
@pytest.mark.parametrize("gmres", [False, True], ids=["ir", "gmres"])
@pytest.mark.parametrize("spd", [False, True], ids=["gesv", "posv"])
def test_mixed_solvers_on_the_card_take_the_float32_kernels(dev, spd, gmres):
    """n = 2048, Schedule.Pallas, float64 working: the float32 factor
    launches the kernels as the mirrors count (chol_base / syrk_diag /
    gemm_sub, or panel_lu), and nothing else; no fallback; the scaled
    residual ||A X - B||_1 / (||A||_1 ||X||_1 n eps) <= 3."""
    import slate_tpu_torch as stt
    from slate_tpu_torch.ops import chol_kernels as ck
    from slate_tpu_torch.ops import lu_kernels as lk

    n, nrhs, nb = 2048, 3, 256
    rng = np.random.default_rng(37)
    a = rng.standard_normal((n, n))
    if spd:
        a = a @ a.T + n * np.eye(n)
    b = rng.standard_normal((n, nrhs))
    grid = stt.ProcessGrid.single()
    A = (stt.HermitianMatrix if spd else stt.Matrix).from_global(a, nb, grid=grid)
    routine = ("posv" if spd else "gesv") + "_mixed" + ("_gmres" if gmres else "")
    X, info, iters = getattr(stt, routine)(A, stt.Matrix.from_global(b, nb, grid=grid),
                                           {"schedule": "pallas"})
    assert int(info) == 0 and iters >= 0
    expect = ck.chol_kernel_launches(n) if spd else {"panel_lu": lk.getrf_kernel_launches(n)}
    assert {k: pk.LAUNCHES[k] for k in expect} == expect
    assert sum(pk.LAUNCHES.values()) == sum(expect.values())
    x = X.to_global().cpu().numpy()
    n1 = lambda m: np.abs(m).sum(axis=0).max()  # noqa: E731
    assert n1(a @ x - b) / (n1(a) * n1(x) * n * np.finfo(np.float64).eps) <= 3


@pytest.mark.cuda
def test_refine_policy_on_a_cuda_operand_is_the_degenerate_float32_pair(dev):
    from slate_tpu_torch.refine import policy

    x = torch.ones(4, device=dev)
    pol = policy.select(x.dtype, 4, backend=x.device.type)
    assert pol.factor == "float32" and pol.degenerate
    assert policy.select(torch.float64, 4, backend=x.device.type).factor == "float32"
    assert policy.factor_dtype(np.complex128, x.device.type) == np.dtype(np.complex64)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rand", "randn"])
def test_generate_tiles_bitwise_across_tilings_on_the_card(dev, kind):
    """generate_matrix of a 4096^2 matrix in tiles of 512, 256 and 384
    (ragged): the same bits; rand equal to the host Philox."""
    import slate_tpu_torch as stt
    from slate_tpu_torch.matgen import philox

    n, seed = 4096, 99
    got = {nb: stt.generate_matrix(kind, stt.Matrix.zeros(n, n, nb, dtype=torch.float64),
                                   seed=seed)[0].to_global() for nb in (512, 256, 384)}
    assert torch.equal(got[512], got[256]) and torch.equal(got[512], got[384])
    if kind == "rand":
        i, j = np.arange(0, n, 7)[:, None], np.arange(0, n, 5)[None, :]
        ref = philox.random_np("uniform", seed, i + 0 * j, j + 0 * i)
        np.testing.assert_array_equal(got[512][::7, ::5].cpu().numpy(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("routine", ["posv", "gesv"])
def test_serve_hit_stream_launches_only_the_trsm_pair(dev, routine):
    """A factor-cache hit stream at n = 2048 on the card: after one miss
    and warmup(), the window makes no cold build, launches only the trsm
    pair (trsm_kernel_launches(2048) a dispatch each), and every X meets
    the scaled residual bound."""
    from slate_tpu_torch.aux import metrics
    from slate_tpu_torch.serve import FactorCache, SolverService

    n, nrhs = 2048, 16
    rng = np.random.default_rng(5)
    G = rng.standard_normal((n, n))
    A = G @ G.T + n * np.eye(n) if routine == "posv" else G + 2 * np.sqrt(n) * np.eye(n)
    Bs = [rng.standard_normal((n, nrhs)) for _ in range(8)]
    was_on = metrics.is_on()
    metrics.on()
    s = SolverService(factor_cache=FactorCache(max_entries=4), batch_max=4,
                      batch_window_s=0.002)
    try:
        s.submit(routine, A, Bs[0]).result(timeout=600)
        s.warmup()

        def runs():
            return sum(int(v["count"]) for k, v in metrics.timers().items()
                       if k.startswith(f"serve.{routine}.") and ".solve.b" in k
                       and k.endswith(".run"))

        runs0 = runs()
        pk.reset_launches()
        with metrics.deltas() as d:
            futs = [s.submit(routine, A, B) for B in Bs]
            Xs = [f.result(timeout=600) for f in futs]
            assert d.get("serve.factor_cache.hit") == len(Bs)
            assert d.get("jit.compilations") == 0
        launched = {k: v for k, v in pk.LAUNCHES.items() if v}
        assert set(launched) == {"trsm_lower", "trsm_upper"}, launched
        expect = pk.trsm_kernel_launches(n) * (runs() - runs0)  # one sweep a dispatch
        assert launched == {"trsm_lower": expect, "trsm_upper": expect}
        for B, X in zip(Bs, Xs):
            r = np.linalg.norm(A @ X - B, 1) / (np.linalg.norm(A, 1) * np.linalg.norm(X, 1)
                                                * n * np.finfo(np.float64).eps)
            assert r <= 3, r
    finally:
        s.stop()
        if not was_on:
            metrics.off()


def _band(rng, n, kl, ku, dtype):
    i = np.arange(n)
    mask = ((i[None, :] - i[:, None]) <= ku) & ((i[:, None] - i[None, :]) <= kl)
    return ((rng.standard_normal((n, n)) + 2 * np.eye(n)) * mask).astype(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w,kl", [(128, 128), (40, 33)])
def test_panel_lu_at_the_band_window_bitwise(dev, dtype, w, kl):
    """panel_lu on a (w + kl, w) window view of a padded band tensor (row
    stride the padded width), as band_getrf calls it: lu and perm bit
    for bit as the plain version's."""
    rng = np.random.default_rng(w + kl)
    G = torch.from_numpy(_rand(rng, 3 * (w + kl), 4 * w, dtype)).to(dev)
    P = G[w:2 * w + kl, w:2 * w]
    got, perm = pk.panel_lu(P)
    ref, ref_perm = pk.panel_lu_plain(P)
    assert pk.LAUNCHES["panel_lu"] == 1
    assert torch.equal(perm, ref_perm) and torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_gbtrf_kernel_route_matches_plain_route(dev, dtype, monkeypatch):
    """gbtrf at n = 2100, kl = 64, ku = 50 on the card: one panel_lu launch
    a window (ceil(n / w)), lperms, perm and LU equal to a run with the
    plain panel forced; gbsv within the JAX package's bound (30)."""
    import slate_tpu_torch as stt
    from slate_tpu_torch.ops import band_kernels as bk

    n, kl, ku, nb = 2100, 64, 50, 256
    rng = np.random.default_rng(31)
    a, b = _band(rng, n, kl, ku, dtype), _rand(rng, n, 3, dtype)
    grid = stt.ProcessGrid.single()
    Am = stt.BandMatrix.from_global(a, kl, ku, nb, grid=grid)
    LU, piv, info = stt.gbtrf(Am)
    w = piv.band_w
    assert pk.LAUNCHES["panel_lu"] == -(-n // w) and piv.band_lperms.shape == (-(-n // w), w + kl)
    monkeypatch.setattr(bk, "_panel_route", lambda dt, d: pk.panel_lu_plain)
    LU_p, piv_p, _ = stt.gbtrf(Am)
    assert pk.LAUNCHES["panel_lu"] == -(-n // w)
    assert torch.equal(piv.band_lperms, piv_p.band_lperms) and torch.equal(piv.perm, piv_p.perm)
    assert torch.equal(LU.data, LU_p.data)
    X = stt.gbtrs(LU, piv, stt.Matrix.from_global(b, nb, grid=grid))
    x = X.to_global().cpu().double().numpy()
    n1 = lambda m: np.abs(m).sum(axis=0).max()  # noqa: E731
    r = n1(a.astype(np.float64) @ x - b) / (n1(a) * n1(x) * n * np.finfo(dtype).eps)
    assert int(info) == 0 and r <= 30, r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_hesv_on_the_card_is_pivot_free(dev, dtype):
    """hesv of chip_smoke.py phase 14's operand, (G + G^T)/2 + 3 sqrt(n)
    diag(s) with s = +-1, at n = 2048: the pivot-free LDL^H (no Aasen, no
    butterfly), getrf_kernel_launches(2048) panel_lu launches without
    pivot search, scaled residual <= 3; the butterfly refactor of
    kron(I, [[0, 1], [1, 0]]) launches butterfly_level 2 log2(n) times a
    factor and a solve."""
    import slate_tpu_torch as stt
    from slate_tpu_torch.ops import lu_kernels as lk

    n, nb = 2048, 256
    rng = np.random.default_rng(37)
    g = rng.standard_normal((n, n))
    s = np.where(rng.standard_normal(n) >= 0, 1.0, -1.0)
    a = ((g + g.T) / 2 + 3 * np.sqrt(n) * np.diag(s)).astype(dtype)
    b = _rand(rng, n, 4, dtype)
    grid = stt.ProcessGrid.single()
    X, L, d, info = stt.hesv(stt.HermitianMatrix.from_global(a, nb, grid=grid),
                             stt.Matrix.from_global(b, nb, grid=grid))
    assert int(info) == 0
    assert getattr(L, "_aasen", None) is None and getattr(L, "_rbt", None) is None
    assert pk.LAUNCHES["panel_lu"] == lk.getrf_kernel_launches(n)
    x = X.to_global().cpu().double().numpy()
    n1 = lambda m: np.abs(m).sum(axis=0).max()  # noqa: E731
    r = n1(a.astype(np.float64) @ x - b) / (n1(a) * n1(x) * n * np.finfo(dtype).eps)
    assert r <= 3, r
    k = np.kron(np.eye(n // 2), np.array([[0.0, 1.0], [1.0, 0.0]])).astype(dtype)
    pk.reset_launches()
    L, d, info = stt.hetrf(stt.HermitianMatrix.from_global(k, nb, grid=grid), method="rbt")
    assert getattr(L, "_rbt", None) is not None and pk.LAUNCHES["butterfly_level"] == 2 * 11
    pk.reset_launches()
    X = stt.hetrs(L, d, stt.Matrix.from_global(b, nb, grid=grid))
    assert pk.LAUNCHES["butterfly_level"] == 2 * 11
    x = X.to_global().cpu().double().numpy()
    r = n1(k.astype(np.float64) @ x - b) / (n1(k) * n1(x) * n * np.finfo(dtype).eps)
    assert r <= 1000, r


@pytest.mark.cuda
def test_complex_band_and_indefinite_on_the_card_take_no_kernel(dev):
    """complex128 pbsv, gbsv and hesv at n = 600 on the card: the plain
    panel and the flat / recursive schedules, no kernel launched."""
    import slate_tpu_torch as stt

    n, nb, kd = 600, 128, 20
    rng = np.random.default_rng(41)
    grid = stt.ProcessGrid.single()
    c = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    i = np.arange(n)
    band = np.abs(i[:, None] - i[None, :]) <= kd
    h = (c + c.conj().T) / 2
    spd = h * band + (2 * kd + 2) * np.eye(n)
    b = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    B = stt.Matrix.from_global(b, nb, grid=grid)
    M = stt.Matrix.from_global(np.tril(spd), nb, grid=grid)
    X1, _, info1 = stt.pbsv(stt.HermitianBandMatrix(M.data, M.layout, grid=grid, kd=kd), B)
    gb = (c + 4 * np.sqrt(kd) * np.eye(n)) * band
    X2, _, _, info2 = stt.gbsv(stt.BandMatrix.from_global(gb, kd, kd, nb, grid=grid), B)
    hi = h + 3 * np.sqrt(n) * np.diag(np.where(rng.standard_normal(n) >= 0, 1.0, -1.0))
    X3, L3, _, info3 = stt.hesv(stt.HermitianMatrix.from_global(hi, nb, grid=grid), B)
    n1 = lambda m: np.abs(m).sum(axis=0).max()  # noqa: E731
    for a, X, info in ((spd, X1, info1), (gb, X2, info2), (hi, X3, info3)):
        x = X.to_global().cpu().numpy()
        assert int(info) == 0
        assert n1(a @ x - b) / (n1(a) * n1(x) * n * np.finfo(np.float64).eps) <= 30
    assert getattr(L3, "_aasen", None) is None and getattr(L3, "_rbt", None) is None
    assert all(v == 0 for v in pk.LAUNCHES.values()), pk.LAUNCHES


def _herm_np(rng, n, dtype):
    a = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal((n, n))
    return ((a + a.conj().T) / 2).astype(dtype)


def _eig_bounds(a, w, z, eps):
    """(eigenvalue error / (n eps ||A||_1), ||AZ - Z Lambda||_1 /
    (||A||_1 n eps), ||Z^H Z - I||_1 / (n eps)) against float64 eigvalsh."""
    n = a.shape[0]
    n1 = lambda m: np.abs(m).sum(axis=0).max()  # noqa: E731
    a64 = a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)
    werr = np.abs(w - np.linalg.eigvalsh(a64)).max() / (n * eps * n1(a64))
    if z is None:
        return werr, 0.0, 0.0
    res = n1(a64 @ z - z * w[None, :]) / (n1(a64) * n * eps)
    orth = n1(z.conj().T @ z - np.eye(n)) / (n * eps)
    return werr, res, orth


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", [(np.float64, "host"), (np.float32, "device"),
                                         (np.complex128, "device")])
def test_heev_on_the_card_matches_the_cpu(dev, dtype, route):
    """heev at n = 400, tiles of 64 (two-stage) on the card against the
    port's CPU result: the float64 chase on the native host chaser, the
    float32 and complex128 chases on the device wavefront (counted in
    heev.hb2st.*); eigenvalues within 10 n eps ||A||_1, residual and
    orthogonality <= 100; the vectors up to sign (phase) where the
    spectrum is separated; no kernel launched (heev reaches none)."""
    import slate_tpu_torch as stt
    from slate_tpu_torch.aux import metrics

    n, nb = 400, 64
    a = _herm_np(np.random.default_rng(43), n, dtype)
    metrics.on()
    with metrics.deltas() as d:
        w, Z = stt.heev(stt.HermitianMatrix.from_global(a, nb, grid=stt.ProcessGrid.single()))
        counts = {k: d.get(f"heev.hb2st.{k}") for k in ("host", "device")}
    assert counts == {"host": int(route == "host"), "device": int(route == "device")}, counts
    w, z = w.cpu().double().numpy(), Z.to_global().cpu().numpy()
    eps = np.finfo(dtype).eps
    werr, res, orth = _eig_bounds(a, w, z.astype(np.complex128 if np.iscomplexobj(z)
                                                  else np.float64), eps)
    assert werr <= 10 and res <= 100 and orth <= 100, (werr, res, orth)
    cpu = stt.ProcessGrid.single("cpu")
    wc, Zc = stt.heev(stt.HermitianMatrix.from_global(a, nb, grid=cpu))
    wc, zc = wc.double().numpy(), Zc.to_global().numpy()
    np.testing.assert_allclose(w, wc, rtol=0, atol=10 * n * eps * np.abs(a).sum(0).max())
    gaps = np.diff(wc)
    gap = np.minimum(np.concatenate([[np.inf], gaps]), np.concatenate([gaps, [np.inf]]))
    sep = gap > 1e-2 * np.abs(a).sum(0).max()
    p = np.abs(z.conj().T @ zc)[np.ix_(sep, sep)]
    np.testing.assert_allclose(p, np.eye(int(sep.sum())), rtol=0, atol=1e3 * n * eps)
    assert all(v == 0 for v in pk.LAUNCHES.values()), pk.LAUNCHES


@pytest.mark.cuda
def test_heev_staged_on_the_card(dev):
    """On the card heev's two-stage path is heev_staged: the four stage
    times, the host chaser for float64, the bounds; values only through
    the Sturm bisection."""
    import slate_tpu_torch as stt
    from slate_tpu_torch.aux import metrics

    n, nb = 1100, 128
    a = _herm_np(np.random.default_rng(47), n, np.float64)
    A = stt.HermitianMatrix.from_global(a, nb, grid=stt.ProcessGrid.single())
    metrics.on()
    with metrics.deltas() as d:
        w, Z, times = stt.drivers.heev_staged(A)
        assert d.get("heev.hb2st.host") == 1 and d.get("heev.hb2st.device") == 0
    assert list(times) == ["he2hb+gather", "hb2st", "stedc+unmtr_hb2st", "unmtr_he2hb"]
    werr, res, orth = _eig_bounds(a, w.cpu().numpy(), Z.to_global().cpu().numpy(),
                                  np.finfo(np.float64).eps)
    assert werr <= 10 and res <= 100 and orth <= 100, (werr, res, orth)
    with metrics.deltas() as d:
        w2, _ = stt.heev(A)
        assert d.get("heev_staged.calls") == 1
    np.testing.assert_array_equal(w2.cpu().numpy(), w.cpu().numpy())
    wv, none, tv = stt.drivers.heev_staged(A, vectors=False)
    assert none is None and list(tv) == ["he2hb+gather", "hb2st", "eigvals"]
    assert _eig_bounds(a, wv.cpu().numpy(), None, np.finfo(np.float64).eps)[0] <= 10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_hegv_on_the_card_launches_the_cholesky_kernels(dev, dtype):
    """hegv itype 1 at n = 2100 (B = X X^T + n I): potrf(B) launches the
    Cholesky kernels at chol_kernel_launches(n); hegst and the
    back-transform are library solves; ||AX - BX Lambda||_1 /
    (||A||_1 ||X||_1 n eps) <= 100."""
    import slate_tpu_torch as stt
    from slate_tpu_torch.ops import chol_kernels as ck

    n, nb = 2100, 128
    rng = np.random.default_rng(53)
    a = _herm_np(rng, n, dtype)
    x = rng.standard_normal((n, n))
    b = (x @ x.T + n * np.eye(n)).astype(dtype)
    grid = stt.ProcessGrid.single()
    w, X, info = stt.hegv(1, stt.HermitianMatrix.from_global(a, nb, grid=grid),
                          stt.HermitianMatrix.from_global(b, nb, grid=grid))
    assert int(info) == 0
    expect = ck.chol_kernel_launches(n)
    got = {k: pk.LAUNCHES[k] for k in expect}
    assert got == expect, (got, expect)
    assert all(v == 0 for k, v in pk.LAUNCHES.items() if k not in expect), pk.LAUNCHES
    w, xg = w.cpu().double().numpy(), X.to_global().cpu().double().numpy()
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    n1 = lambda m: np.abs(m).sum(axis=0).max()  # noqa: E731
    r = n1(a64 @ xg - (b64 @ xg) * w[None, :]) / (n1(a64) * n1(xg) * n * np.finfo(dtype).eps)
    assert r <= 100, r


@pytest.mark.cuda
def test_heev_float32_raises_under_tf32(dev):
    """A float32 heev on the card raises while TF32 is on, as the other
    float32 drivers do."""
    import slate_tpu_torch as stt

    a = _herm_np(np.random.default_rng(59), 300, np.float32)
    A = stt.HermitianMatrix.from_global(a, 64, grid=stt.ProcessGrid.single())
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="tf32"):
            stt.heev(A)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _svd_card_and_cpu(dev, a, nb):
    """svd of a with vectors on the card (its hb2st route counts and
    kernel launches) and on the CPU, as float64 numpy."""
    import slate_tpu_torch as stt
    from slate_tpu_torch.aux import metrics

    metrics.on()
    with metrics.deltas() as d:
        s, U, Vh = stt.svd(stt.Matrix.from_global(a, nb, grid=stt.ProcessGrid.single()),
                           vectors=True)
        counts = {c: d.get(f"svd.hb2st.{c}") for c in ("host", "device")}
    launches = dict(pk.LAUNCHES)
    card = [x.cpu().double().numpy() for x in (s, U.to_global(), Vh.to_global())]
    cpu = stt.ProcessGrid.single("cpu")
    sc, Uc, Vhc = stt.svd(stt.Matrix.from_global(a, nb, grid=cpu), vectors=True)
    return card, [x.double().numpy() for x in (sc, Uc.to_global(), Vhc.to_global())], counts, \
        launches


def _svd_bounds(a, s, u, vh, eps):
    """(values error / (max(m, n) eps ||A||_1) against float64 numpy,
    ||A - U S V^H||_1 / (||A||_1 max(m, n) eps), ||U^H U - I||_1 / (k eps),
    ||V^H V - I||_1 / (k eps))."""
    m, n = a.shape
    k, mx = min(m, n), max(m, n)
    n1 = lambda x: np.abs(x).sum(axis=0).max()  # noqa: E731
    a64 = a.astype(np.float64)
    serr = np.abs(s - np.linalg.svd(a64, compute_uv=False)).max() / (mx * eps * n1(a64))
    rec = n1(a64 - (u * s) @ vh) / (n1(a64) * mx * eps)
    return (serr, rec, n1(u.T @ u - np.eye(k)) / (k * eps), n1(vh @ vh.T - np.eye(k)) / (k * eps))


def _same_left_vectors(s, u, uc, a, eps):
    """U of the card against U of the CPU, up to sign, on the singular
    values separated by more than 1e-2 ||A||_1."""
    k = u.shape[1]
    a1 = np.abs(a.astype(np.float64)).sum(axis=0).max()
    gaps = np.abs(np.diff(s))
    gap = np.minimum(np.concatenate([[np.inf], gaps]), np.concatenate([gaps, [np.inf]]))
    sep = gap > 1e-2 * a1
    p = np.abs(u.T @ uc)[np.ix_(sep, sep)]
    np.testing.assert_allclose(p, np.eye(int(sep.sum())), rtol=0, atol=1e3 * k * eps)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,dtype", [(400, 400, np.float64), (400, 400, np.float32),
                                       (900, 300, np.float64)])
def test_svd_on_the_card_matches_the_cpu(dev, m, n, dtype):
    """svd with vectors at (400, 400) and (900, 300) (the tall
    pre-reduction) with tiles of 64, where the band stage is
    ``svd_accurate`` (n <= 4 (2 nb + 1)): no hb2st chase, no kernel (the
    library QR below n = 2048); values within 10 max(m, n) eps ||A||_1
    of float64 numpy and of the CPU's, reconstruction and orthogonality
    <= 100, U up to sign where the spectrum is separated."""
    a = _rand(np.random.default_rng(61), m, n, dtype)
    (s, u, vh), (sc, uc, _), counts, launches = _svd_card_and_cpu(dev, a, 64)
    assert counts == {"host": 0, "device": 0}, counts
    assert all(v == 0 for v in launches.values()), launches
    eps = np.finfo(dtype).eps
    serr, rec, ou, ov = _svd_bounds(a, s, u, vh, eps)
    assert serr <= 10 and rec <= 100 and ou <= 100 and ov <= 100, (serr, rec, ou, ov)
    np.testing.assert_allclose(s, sc, rtol=0, atol=10 * max(m, n) * eps
                               * np.abs(a.astype(np.float64)).sum(axis=0).max())
    _same_left_vectors(sc, u, uc, a, eps)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,dtype,route", [(400, 400, np.float64, "host"),
                                             (400, 400, np.float32, "device"),
                                             (900, 300, np.float64, "host")])
def test_svd_jw_route_on_the_card_matches_the_cpu(dev, m, n, dtype, route):
    """The same shapes with tiles of 32, so that both take the
    Jordan-Wielandt route (n > 4 (2 nb + 1) = 260): the float64 chase
    on the native host chaser, the float32 chase on the device wavefront
    (counted in svd.hb2st.*); larft launched as the QR route resolves
    (the library QR below n = 2048: none), no other kernel; the bounds
    as above, U up to sign where the spectrum is separated.  The JW
    tridiagonals (2n = 800, 600) are padded in stedc, whose padding
    poles must not widen its deflation tolerance (ROADMAP.md Queue 3)."""
    from slate_tpu_torch.ops import qr_fast as qf

    nb = 32
    a = _rand(np.random.default_rng(61), m, n, dtype)
    (s, u, vh), (sc, uc, _), counts, launches = _svd_card_and_cpu(dev, a, nb)
    assert counts == {"host": int(route == "host"), "device": int(route == "device")}, counts
    tall_route = qf.resolve_qr_schedule(-(-m // nb) * nb, -(-n // nb) * nb,
                                        torch.float64 if dtype == np.float64 else torch.float32,
                                        "auto", dev) if m >= 2 * n else None
    expect = qf.geqrf_kernel_launches(n) if tall_route == "pallas" else 0
    assert launches["larft"] == expect, (launches, tall_route)
    assert all(v == 0 for c, v in launches.items() if c != "larft"), launches
    eps = np.finfo(dtype).eps
    serr, rec, ou, ov = _svd_bounds(a, s, u, vh, eps)
    assert serr <= 10 and rec <= 100 and ou <= 100 and ov <= 100, (serr, rec, ou, ov)
    np.testing.assert_allclose(s, sc, rtol=0, atol=10 * max(m, n) * eps
                               * np.abs(a.astype(np.float64)).sum(axis=0).max())
    _same_left_vectors(sc, u, uc, a, eps)


@pytest.mark.cuda
def test_svd_float32_raises_under_tf32(dev):
    """A float32 svd on the card raises while TF32 is on, as heev does."""
    import slate_tpu_torch as stt

    a = _rand(np.random.default_rng(67), 300, 300, np.float32)
    A = stt.Matrix.from_global(a, 32, grid=stt.ProcessGrid.single())
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="tf32"):
            stt.svd(A)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _serve_mirror(routine, n, items):
    """The kernel launches of ``items`` full-phase bucket cores at bucket
    n, tiles of 64: the factor's mirror (the drivers' own solves are
    library triangular solves; the trsm pair runs on hit buckets)."""
    from slate_tpu_torch.ops import chol_kernels as ck
    from slate_tpu_torch.ops import lu_kernels as lk

    one = (ck.chol_kernel_launches(n) if routine == "posv"
           else {"panel_lu": lk.getrf_kernel_launches(n, 256, 1)})
    return {k: v * items for k, v in one.items() if v}


def _scaled_residual(A, X, B):
    return np.linalg.norm(A @ X - B, 1) / (np.linalg.norm(A, 1) * np.linalg.norm(X, 1)
                                           * A.shape[0] * np.finfo(np.float64).eps)


@pytest.mark.cuda
@pytest.mark.parametrize("routine", ["gesv", "posv"])
def test_integrity_abft_bucket_launches_the_mirror(dev, routine):
    """An ABFT bucket at n = 2100 (bucket 4096, tiles of 64) on the card:
    certified with no failure, info 0, and exactly the kernels of the
    factor's mirror; a corrupted factor entry flags the on-device
    checksum relation."""
    from slate_tpu_torch.aux import metrics
    from slate_tpu_torch.integrity import abft
    from slate_tpu_torch.serve import SolverService, bucket_for

    n, nrhs = 2100, 16
    rng = np.random.default_rng(6)
    G = rng.standard_normal((n, n))
    A = G @ G.T + n * np.eye(n) if routine == "posv" else G + 2 * np.sqrt(n) * np.eye(n)
    B = rng.standard_normal((n, nrhs))
    key = bucket_for(routine, n, n, nrhs, np.float64, tag=abft.ABFT_TAG)
    was_on = metrics.is_on()
    metrics.on()
    s = SolverService(integrity="full,abft,hedge=0", factor_cache=False, batch_max=1)
    try:
        with metrics.deltas() as d:
            X = s.submit(routine, A, B).result(timeout=600)
            assert d.get("serve.integrity.checked") == 1 and d.get("serve.integrity.fail") == 0
        assert _scaled_residual(A, X, B) <= 3
        launched = {k: v for k, v in pk.LAUNCHES.items() if v}
        assert launched == _serve_mirror(routine, key.n, 1), launched
        core = s.cache.executable(key, 1)
        Ap = torch.zeros((1, key.n, key.n), dtype=torch.float64, device=dev)
        Ap[0, :n, :n] = torch.from_numpy(A)
        Ap[0, n:, n:].diagonal().fill_(1)
        Bp = torch.zeros((1, key.n, key.nrhs), dtype=torch.float64, device=dev)
        Bp[0, :n, :nrhs] = torch.from_numpy(B)
        Xb, info = core(Ap, Bp)
        assert int(info[0]) == 0
        Ag, Bg, Xg = Ap[0], Bp[0], Xb[0]
        if routine == "gesv":
            from slate_tpu_torch.serve.factor_cache import factor_only

            F, perm = factor_only("gesv", Ag.cpu().numpy(), device=dev)
            assert not bool(abft.gesv_check(Ag, Bg, F, perm, Xg))
            F[5, 9] = F[5, 9] * 2 + 1
            assert bool(abft.gesv_check(Ag, Bg, F, perm, Xg))
        else:
            L = torch.linalg.cholesky(Ag)
            assert not bool(abft.posv_check(Ag, Bg, L, Xg))
            L[9, 5] = L[9, 5] * 2 + 1
            assert bool(abft.posv_check(Ag, Bg, L, Xg))
    finally:
        s.stop()
        if not was_on:
            metrics.off()


@pytest.mark.cuda
def test_artifact_restore_from_a_store_on_the_card(dev, tmp_path):
    """A store warmed on the card holds the kernel library under its
    digest; a second cache restores every entry from it (no build), and
    a flipped byte is counted corrupt, rebuilt and re-saved."""
    from slate_tpu_torch.aux import metrics
    from slate_tpu_torch.serve import ArtifactStore, ExecutableCache, SolverService

    n, nrhs = 512, 4
    rng = np.random.default_rng(8)
    A = rng.standard_normal((n, n)) + 2 * np.sqrt(n) * np.eye(n)
    B = rng.standard_normal((n, nrhs))
    man, store = str(tmp_path / "m.json"), str(tmp_path / "store")
    was_on = metrics.is_on()
    metrics.on()
    s = SolverService(cache=ExecutableCache(manifest_path=man, artifact_dir=store),
                      factor_cache=False, batch_max=2)
    try:
        assert s.wait_ready(60)
        X = s.submit("gesv", A, B).result(timeout=600)
        assert _scaled_residual(A, X, B) <= 3
        s.warmup()
    finally:
        s.stop()
    st = ArtifactStore(store)
    libdir = tmp_path / "store" / "kernels" / pk.library_digest()
    assert sorted(p.name for p in pk.check_copy(libdir, pk.library_digest())) \
        == sorted(pk.library_names())
    assert len(st.entries()) == 2
    with metrics.deltas() as d:
        got = ExecutableCache(manifest_path=man, artifact_dir=store).restore(devices=[dev])
        assert got == {"entries": 2, "restored": 2, "compiled": 0, "failed": 0, "skipped": 0}
        assert d.get("serve.artifact_hit") == 2
    path = st.entries()[0]["path"]
    blob = open(path, "rb").read()
    open(path, "wb").write(ArtifactStore._flip_byte(blob))
    with metrics.deltas() as d:
        got = ExecutableCache(manifest_path=man, artifact_dir=store).restore(devices=[dev])
        assert got["restored"] == 1 and got["compiled"] == 1
        assert d.get("serve.artifact_corrupt") == 1
    assert open(path, "rb").read().split(b"\n", 1)[1] == blob.split(b"\n", 1)[1]
    if not was_on:
        metrics.off()


_RESTORE_CHILD = r"""
import json, sys, torch
from slate_tpu_torch.aux import metrics
from slate_tpu_torch.ops.hopper import panel_kernels as pk
from slate_tpu_torch.serve import ExecutableCache
metrics.on()
got = ExecutableCache(manifest_path=sys.argv[1], artifact_dir=sys.argv[2]).restore(
    devices=[torch.device("cuda:0")])
print(json.dumps({"restore": got, "loaded_from": str(pk.LOADED_FROM), "nvcc": pk.NVCC_RUNS,
                  "counters": {k: v for k, v in metrics.counters().items()
                               if k.startswith("serve.artifact_")}}))
"""


@pytest.mark.cuda
def test_artifact_flipped_library_byte_on_the_card(dev, tmp_path):
    """A flipped byte in a stored kernel library fails its sha256 before
    the library is opened: a fresh interpreter counts the entry corrupt,
    runs the library built from the sources, and rewrites the store's
    copy, which then restores clean."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from slate_tpu_torch.aux import metrics
    from slate_tpu_torch.serve import ExecutableCache, SolverService

    n, nrhs = 512, 4
    rng = np.random.default_rng(10)
    A = rng.standard_normal((n, n)) + 2 * np.sqrt(n) * np.eye(n)
    B = rng.standard_normal((n, nrhs))
    man, store = str(tmp_path / "m.json"), str(tmp_path / "store")
    was_on = metrics.is_on()
    metrics.on()
    s = SolverService(cache=ExecutableCache(manifest_path=man, artifact_dir=store),
                      factor_cache=False, batch_max=2)
    try:
        assert _scaled_residual(A, s.submit("gesv", A, B).result(timeout=600), B) <= 3
        s.warmup()
    finally:
        s.stop()
        if not was_on:
            metrics.off()
    libdir = tmp_path / "store" / "kernels" / pk.library_digest()
    so = libdir / pk.library_names()[0]
    blob = bytearray(so.read_bytes())
    blob[len(blob) // 2] ^= 0x01
    so.write_bytes(bytes(blob))
    with pytest.raises(pk.LibraryCorrupt):
        pk.check_copy(libdir, pk.library_digest())
    repo = str(Path(__file__).resolve().parents[1])

    def child():
        out = subprocess.run([sys.executable, "-c", _RESTORE_CHILD, man, store], cwd=repo,
                             env={**os.environ, "PYTHONPATH": repo},
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    got = child()
    assert got["restore"] == {"entries": 2, "restored": 1, "compiled": 1, "failed": 0,
                              "skipped": 0}, got
    assert got["counters"].get("serve.artifact_corrupt") == 1, got
    assert got["loaded_from"] == str(pk.BUILD_DIR), got
    pk.check_copy(libdir, pk.library_digest())  # rewritten clean
    got = child()
    assert got["restore"]["restored"] == 2 and got["loaded_from"] == str(libdir), got


@pytest.mark.cuda
def test_replicas_share_one_card(dev):
    """Two lanes on cuda:0: both serve a full-phase stream, every X meets
    the residual bound, and a lane added warm takes traffic with no cold
    build."""
    from slate_tpu_torch.aux import metrics
    from slate_tpu_torch.serve import SolverService

    n, nrhs = 1024, 8
    rng = np.random.default_rng(9)
    probs = [(rng.standard_normal((n, n)) + 2 * np.sqrt(n) * np.eye(n),
              rng.standard_normal((n, nrhs))) for _ in range(4)]
    was_on = metrics.is_on()
    metrics.on()
    s = SolverService(replicas=2, factor_cache=False, batch_max=2, batch_window_s=0.002)
    try:
        assert [str(r.device) for r in s._replicas] == ["cuda:0", "cuda:0"]
        with metrics.deltas() as d:
            futs = [s.submit("gesv", *probs[i % 4]) for i in range(12)]
            for i, f in enumerate(futs):
                assert _scaled_residual(*probs[i % 4][:1], f.result(timeout=600),
                                        probs[i % 4][1]) <= 3
            assert d.get("serve.replica.0.dispatched") > 0
            assert d.get("serve.replica.1.dispatched") > 0
        s.warmup()
        s.add_replica()
        with metrics.deltas() as d:
            futs = [s.submit("gesv", *probs[i % 4]) for i in range(8)]
            for f in futs:
                f.result(timeout=600)
            assert d.get("jit.compilations") == 0
    finally:
        s.stop()
        if not was_on:
            metrics.off()


@pytest.mark.cuda
def test_devmon_on_the_card(dev, tmp_path):
    """The device monitor on cuda:0: a memory row with bytes in use, a
    peak at or above them and the card's total as the limit; each warmed
    core's cost row with the model FLOPs and a measured peak; a tenancy
    service's health() with its devices, cost and tenants sections."""
    from slate_tpu_torch.aux import devmon, metrics
    from slate_tpu_torch.serve import ExecutableCache, SolverService
    from slate_tpu_torch.serve import buckets as bk

    was = metrics.is_on(), devmon.is_on()
    metrics.on()
    devmon.on()
    n, nrhs = 512, 4
    rng = np.random.default_rng(5)
    A = rng.standard_normal((n, n)) + 2 * np.sqrt(n) * np.eye(n)
    B = rng.standard_normal((n, nrhs))
    s = SolverService(cache=ExecutableCache(manifest_path=str(tmp_path / "m.json")),
                      factor_cache=False, batch_max=2, tenants="gold:weight=4")
    try:
        X = s.submit("gesv", A, B, tenant="gold").result(timeout=600)
        assert _scaled_residual(A, X, B) <= 3
        h = s.health()
        [row] = h["devices"]
        assert row["device"] == "cuda:0" and row["platform"] == "gpu"
        assert row["bytes_in_use"] > 0 and row["peak_bytes_in_use"] >= row["bytes_in_use"]
        assert row["bytes_limit"] == torch.cuda.mem_get_info(0)[1]
        assert devmon.bytes_in_use() == torch.cuda.memory_stats(0)["allocated_bytes.all.current"]
        key = bk.bucket_for("gesv", n, n, nrhs, np.float64)
        cost = s.cache.cost(key, 1)
        assert cost["flops_model"] == bk.phase_flops(key, 1) and cost["peak_bytes"] > 0
        assert cost["device_kind"] == torch.cuda.get_device_name(0).lower()
        assert h["cost"][key.label][1] == cost and h["tenants"]["gold"]["admitted"] == 1
        if "h100" in torch.cuda.get_device_name(0).lower():
            assert devmon.peaks_for()["flops"] == 6.7e13  # the port's h100 row
    finally:
        s.stop()
        if not was[0]:
            metrics.off()
        if not was[1]:
            devmon.off()


@pytest.mark.cuda
def test_fabric_on_the_card(dev):
    """The factor fabric on cuda:0: an armed cache keeps pinned host
    entries (the pack and gesv's permutation) homed on the card, the
    arena's buffers live on the card and a spill frees them; a session's
    fold and streamed solve run on the card, the fold within 100 n eps of
    the same fold on the CPU."""
    from slate_tpu_torch.aux import devmon, metrics
    from slate_tpu_torch.fabric import FactorArena, FactorSession
    from slate_tpu_torch.fabric.session import _update_r
    from slate_tpu_torch.serve import ExecutableCache, FactorCache, SolverService
    from slate_tpu_torch.serve import matrix_fingerprint

    was = metrics.is_on()
    metrics.on()
    rng = np.random.default_rng(7)
    m, n = 512, 256
    A = rng.standard_normal((m, n))
    G = rng.standard_normal((n, n)) + 2 * np.sqrt(n) * np.eye(n)
    s = SolverService(cache=ExecutableCache(manifest_path=None),
                      factor_cache=FactorCache(max_entries=8), factor_arena=FactorArena(),
                      batch_max=2)
    try:
        for routine, M in (("gels", A), ("gesv", G)):
            for _ in range(3):
                B = rng.standard_normal((M.shape[0], 3))
                X = s.submit(routine, M, B).result(timeout=600)
                ref = np.linalg.lstsq(M, B, rcond=None)[0]
                assert np.abs(X - ref).max() <= 1e-9 * max(np.abs(ref).max(), 1.0)
            e = s.factor_cache.get(matrix_fingerprint(M, routine, schedule=s.schedule))
            assert e.factor.device.type == "cpu" and e.factor.is_pinned()
            assert e.home == dev and (e.perm is None or e.perm.is_pinned())
        lane = s._replicas[0].lane
        assert s.arena.stats()["lanes"][lane]["entries"] == 2
        assert all(sl.buf.device == dev for sl in s.arena._lane_slots[lane].values())
        torch.cuda.synchronize()
        before = devmon.bytes_in_use(dev)
        resident = s.arena.stats()["bytes"]
        assert s.arena.spill(lane, keep_frac=0.0) == 2
        assert before - devmon.bytes_in_use(dev) >= resident
        sess = FactorSession(s, A)
        assert sess.device == dev
        C = rng.standard_normal((9, n))
        sess.append(C)
        B = rng.standard_normal((m + 9, 2))
        X = sess.solve(B)
        ref = np.linalg.lstsq(np.vstack([A, C]), B, rcond=None)[0]
        assert np.abs(X - ref).max() <= 1e-9 * max(np.abs(ref).max(), 1.0)
    finally:
        s.stop()
        if not was:
            metrics.off()
    R0 = np.linalg.qr(A, mode="r")
    R, Rd = torch.from_numpy(R0.copy()), torch.from_numpy(R0.copy()).to(dev)
    _update_r(R, torch.from_numpy(C.copy()))
    _update_r(Rd, torch.from_numpy(C.copy()).to(dev))
    assert np.abs(Rd.cpu().numpy() - R.numpy()).max() <= 100 * n * np.finfo(np.float64).eps * \
        np.abs(R.numpy()).max()


@pytest.mark.cuda
def test_soak_replay_on_the_card(dev):
    """A 40-request open-loop replay on cuda:0 at n = 2048 (two lanes, the
    factor cache and certification armed; the trsm pair takes hits from
    n = 2048), recorded off the delivery tap: the books reconcile, the
    recorder holds delivered + typed rows, no wrong X, no orphan trace,
    and the hits ran the trsm pair on the card."""
    from slate_tpu_torch.aux import metrics, spans
    from slate_tpu_torch.serve import FactorCache, PlacementPolicy, SolverService
    from slate_tpu_torch.soak import record, replay
    from slate_tpu_torch.soak.timeline import TimelineSampler

    was = metrics.is_on(), spans.is_on()
    metrics.on()
    metrics.reset()
    spans.on(ring=16384)
    spans.clear()
    s = SolverService(placement=PlacementPolicy(replicas=2, devices=["cuda:0"]),
                      factor_cache=FactorCache(max_entries=8), integrity="full", batch_max=4,
                      batch_window_s=0.002)
    try:
        spec = replay.merge_specs(
            replay.gen_repeated_a(28, seed=1, rate_rps=50, n=2048, nrhs=4, distinct=2),
            replay.gen_multitenant(12, seed=2, rate_rps=25, n_small=2048, n_large=2048,
                                   nrhs=4, distinct=2))
        ops = {}
        replay.replay(s, replay.warm_spec(spec), seed=0, cache=ops)
        s.warmup()
        metrics.reset()
        pk.reset_launches()
        rec = record.Recorder()
        with rec, TimelineSampler(s, period_s=0.01) as sampler:
            res = replay.replay(s, spec, seed=0, cache=ops)
        assert res["submitted"] == 40 == res["delivered"] + res["typed_errors"] + res["refused"]
        assert res["bad_results"] == 0 and sampler.errors == 0
        assert len(rec) == res["delivered"] + res["typed_errors"]
        assert {r["dtype"] for r in rec.rows()} == {"float64"}
        c = metrics.counters()
        assert c["serve.requests"] == c["soak.submitted"] - c.get("soak.refused", 0)
        assert pk.LAUNCHES["trsm_lower"] > 0 and pk.LAUNCHES["trsm_upper"] > 0
        assert spans.pressure()["evicted"] == 0 and replay.orphan_spans() == 0
        assert [r["device"] for r in s.health()["replicas"]] == ["cuda:0", "cuda:0"]
    finally:
        s.stop()
        spans.on(ring=spans.RING)
        if not was[0]:
            metrics.off()
        if not was[1]:
            spans.off()


@pytest.mark.cuda
def test_stepped_scaler_on_the_card(dev, monkeypatch):
    """The autoscaler stepped on its own clock over a service on cuda:0 at
    n = 2048: a 200 ms tax a dispatch queues a burst of factor-cache hits
    on one lane, two steps scale up to 3 lanes (all cuda:0, their primes
    skipped), the drained fleet steps back down to 1; every snapshot reads
    a float device-memory headroom in (0, 1], no step, add or remove
    failed, every X meets the residual bound and the hits ran the trsm
    pair."""
    from slate_tpu_torch.aux import faults, metrics
    from slate_tpu_torch.scale import controller as ctl
    from slate_tpu_torch.serve import FactorCache, PlacementPolicy, SolverService

    monkeypatch.setenv(ctl.SCALE_ENV, "min=1,max=3,up=1.0,down=0.2,up_cooldown=0.25,"
                       "down_cooldown=2.0,step=2,period=3600")
    was = metrics.is_on()
    metrics.on()
    metrics.reset()
    n, nrhs = 2048, 4
    rng = np.random.default_rng(11)
    A = rng.standard_normal((n, n)) + 2 * np.sqrt(n) * np.eye(n)
    Bs = [rng.standard_normal((n, nrhs)) for _ in range(12)]
    s = SolverService(placement=PlacementPolicy(devices=["cuda:0"]), batch_max=1,
                      factor_cache=FactorCache(max_entries=8))
    try:
        sc = s._scaler
        assert sc is not None
        s.submit("gesv", A, Bs[0]).result(timeout=600)  # the miss
        s.warmup()
        pk.reset_launches()
        faults.configure("latency:every=1,ms=200")
        faults.on()
        futs = [s.submit("gesv", A, B) for B in Bs]
        snaps = []
        for now in (0.0, 0.3):
            d = sc.step(now=now)
            snaps.append(d.snapshot)
            assert d.action == ctl.UP, d
        assert [str(r.device) for r in s._replicas] == ["cuda:0"] * 3
        for B, f in zip(Bs, futs):
            assert _scaled_residual(A, f.result(timeout=600), B) <= 3
        faults.reset()
        now = 0.3
        while len(s._replicas) > 1 and now < 30:
            now += 0.5
            snaps.append(sc.step(now=now).snapshot)
        assert len(s._replicas) == 1
        assert all(isinstance(x.hbm_headroom_frac, float) and 0 < x.hbm_headroom_frac <= 1
                   for x in snaps), snaps
        c = metrics.counters()
        assert (c.get("scale.up"), c.get("scale.down")) == (2, 2)
        assert all(c.get(k, 0) == 0 for k in ("scale.step_errors", "scale.add_failed",
                                              "scale.remove_failed"))
        assert c.get("scale.prime_skipped", 0) >= 2 and c.get("serve.device_primes", 0) == 0
        assert pk.LAUNCHES["trsm_lower"] > 0 and pk.LAUNCHES["trsm_upper"] > 0
    finally:
        faults.reset()
        s.stop()
        if not was:
            metrics.off()
