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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lower,unit,trans", [
    (True, False, False), (True, True, False), (False, False, False), (False, False, True),
    (True, False, True),
])
@pytest.mark.parametrize("n,nrhs", [(101, 7), (300, 1)])
def test_trsm_packed_storage(dev, dtype, lower, unit, trans, n, nrhs):
    """op(T) X = B with NaN in the unread triangle (and on the unread unit
    diagonal): the result is finite and agrees with the plain solve."""
    rng = np.random.default_rng(n + 2 * lower + unit + 4 * trans)
    stored_lower = lower != trans
    t = _tri(rng, n, dtype, stored_lower, unit)
    ones = np.ones((n, n), bool)
    other = np.triu(ones, 0 if unit else 1) if stored_lower else np.tril(ones, -1 if not unit else 0)
    _, t_dev = _both(np.where(other, np.nan, t), dev)
    b_cpu, b = _both(_rand(rng, n, nrhs, dtype), dev)
    if lower:
        got = pk.trsm_lower(t_dev, b, unit=unit, transposed=trans)
    else:
        got = pk.trsm_upper(t_dev, b, transposed=trans)
    got = got.cpu().numpy()
    ref = pk.trsm_plain(torch.from_numpy(t), b_cpu, lower, unit, trans).numpy()
    assert got.shape == (n, nrhs)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype, n, ref))
    assert pk.LAUNCHES["trsm_lower" if lower else "trsm_upper"] == 1


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
    assert pk.LAUNCHES["trsm_lower"] == 1 and pk.LAUNCHES["trsm_upper"] == 1
    np.testing.assert_allclose(Y.cpu().numpy(), x, rtol=0, atol=_tol(np.float64, n, x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_gemm_sub_large_tiles_ragged(dev, dtype):
    """An output of 13 x 13 tiles of 128 fills the card: the 128 x 128
    tile variant runs, with ragged edges on every side."""
    rng = np.random.default_rng(23)
    M, N, K = 1601, 1550, 333
    c_cpu, c = _both(_rand(rng, M + 3, N + 5, dtype), dev)
    a_cpu, a = _both(_rand(rng, M, K + 7, dtype), dev)
    b_cpu, b = _both(_rand(rng, N, K + 1, dtype), dev)
    got = pk.gemm_sub(c[3:, 5:], a[:, 7:], b[:, 1:]).cpu().numpy()
    ref = pk.gemm_sub(c_cpu[3:, 5:], a_cpu[:, 7:], b_cpu[:, 1:]).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype, K, ref))


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
    assert pk.LAUNCHES["trsm_lower"] == 1 and pk.LAUNCHES["trsm_upper"] == 1
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
                                         (3000, 256, False), (40, 64, True)])
def test_larft_matches_plain(dev, dtype, m, w, strided):
    """T^-1: diagonal bitwise, lower triangle exactly zero, the strict
    upper Gram within tolerance; T through the library solve agrees."""
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
