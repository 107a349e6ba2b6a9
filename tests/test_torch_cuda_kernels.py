"""The Hopper kernels of slate_tpu_torch against their plain PyTorch
versions on the card, at ragged shapes and strided views that the main
path of chip_smoke.py does not reach.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  This file imports neither JAX nor the JAX package, so it runs
on a machine without them; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: ``50 n eps max|ref|``, as in tests/test_pallas_panels.py."""

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
