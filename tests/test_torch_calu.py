"""Port parity: tournament pivoting (CALU) of slate_tpu_torch —
``tournament_pivots``, ``blocked_getrf_tntpiv`` and ``getrf``/``gesv``
with ``MethodLU.CALU`` / ``BEAM`` — against the JAX package on the CPU.

The same seeded numpy inputs go through both packages.  Pivot orders
must be bitwise equal (random inputs have no exact ties); LU and X agree
within ``50 n eps max|ref|``, as in tests/test_torch_lu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
import slate_tpu_torch as stt
from slate_tpu.ops import lu_kernels as jlk
from slate_tpu.testing import checks
from slate_tpu_torch.ops import lu_kernels as tlk
from slate_tpu_torch.ops.hopper import panel_kernels as pk

torch.set_num_threads(1)

CPU = stt.ProcessGrid.single("cpu")


def _tol(n, ref, dtype=np.float64):
    return 50 * n * np.finfo(dtype).eps * max(float(np.abs(ref).max()), 1.0)


@pytest.fixture(autouse=True)
def _no_launches():
    pk.reset_launches()
    yield
    assert all(v == 0 for v in pk.LAUNCHES.values()), pk.LAUNCHES  # CPU: plain versions


@pytest.mark.parametrize("M,nb,chunk", [(128, 8, 32), (96, 8, 32), (160, 8, 32),
                                        (224, 8, 32), (64, 16, 64), (48, 16, 16)])
def test_tournament_pivots_match_jax(M, nb, chunk):
    """Bracket counts 4, 3 (odd: a bye), 5, 7 and 1, and chunk == nb;
    the wrapper (its plain version on the CPU) and the plain version."""
    panel = np.random.default_rng(M + nb).standard_normal((M, nb))
    ref = np.asarray(jlk.tournament_pivots(jnp.asarray(panel), nb, chunk))
    for fn in (pk.panel_lu, pk.panel_lu_plain):
        got = tlk.tournament_pivots(torch.from_numpy(panel), nb, chunk, fn)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_tournament_pivots_selects_largest():
    """tests/test_lu.py::test_tournament_pivots_selects_largest."""
    rng = np.random.default_rng(42)
    panel = rng.standard_normal((128, 8)) * 0.1
    panel[77, 0] = 100.0
    got = tlk.tournament_pivots(torch.from_numpy(panel), 8, 32, pk.panel_lu)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jlk.tournament_pivots(jnp.asarray(panel), 8, 32)))
    assert int(got[0]) == 77 and len(set(got.tolist())) == 8


def test_tournament_bye_rows_lose_ties():
    """A zero column pits real zero rows against the bye's zero rows: the
    real rows come first in each play, so no bye index (M) wins."""
    panel = np.random.default_rng(3).standard_normal((96, 8))
    panel[:, 0] = 0.0
    ref = np.asarray(jlk.tournament_pivots(jnp.asarray(panel), 8, 32))
    got = tlk.tournament_pivots(torch.from_numpy(panel), 8, 32, pk.panel_lu)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got < 96).all()


class _Counting:
    """A panel factor that counts its calls (the kernel's launches on a
    CUDA device) and runs the plain version."""

    def __init__(self):
        self.calls = 0

    def __call__(self, panel, pivot=True, act=None):
        self.calls += 1
        return pk.panel_lu_plain(panel, pivot, act)


@pytest.mark.parametrize("Mp,Np,nb,chunk", [(112, 112, 16, 0), (112, 64, 16, 0),
                                            (64, 112, 16, 0), (96, 96, 8, 24)])
def test_blocked_getrf_tntpiv_matches_jax(Mp, Np, nb, chunk):
    """Both panel routes (the wrapper, which runs its plain version on
    the CPU, and the plain version itself) give the JAX package's perm
    bit for bit; ``tntpiv_kernel_launches`` counts the panel factors."""
    g = np.random.default_rng(Mp + Np + nb).standard_normal((Mp, Np))
    ref_lu, ref_p = jlk.blocked_getrf_tntpiv(jnp.asarray(g), nb, chunk)
    ref_lu = np.asarray(ref_lu)
    counting = _Counting()
    runs = [tlk.blocked_getrf_tntpiv(torch.from_numpy(g), nb, chunk, panel_fn=fn)
            for fn in (pk.panel_lu, pk.panel_lu_plain, counting)]
    for lu, p in runs:
        np.testing.assert_array_equal(p.numpy(), np.asarray(ref_p))
        np.testing.assert_allclose(lu.numpy(), ref_lu, rtol=0, atol=_tol(Mp, ref_lu))
    np.testing.assert_array_equal(runs[0][0].numpy(), runs[1][0].numpy())
    assert counting.calls == tlk.tntpiv_kernel_launches(Mp, Np, nb, chunk)


def test_tntpiv_kernel_launches_of_the_main_path():
    """n = 16384 in tiles of 512: 8 elections, 4 + 2 + 1 plays and one
    factor a step, 32 steps."""
    assert tlk.tntpiv_kernel_launches(16384, 16384, 512) == 512
    assert tlk.tntpiv_kernel_launches(2048, 2048, 512) == 4 * 2
    assert tlk.tntpiv_kernel_launches(96, 96, 8, 32) == 12 * (3 + 2 + 1 + 1)


@pytest.mark.parametrize("Mp,Np,nb,chunk", [(112, 112, 16, 0), (96, 96, 8, 24)])
def test_tntpiv_schedule_flops_counts_the_panels_run(Mp, Np, nb, chunk):
    """The mirror's exec equals the panel factors the loop runs (2 M nb^2
    each, shapes observed) plus a U-row solve and a full-shape trailing
    product a step; getrf with CALU records it."""
    from slate_tpu_torch.aux import metrics

    shapes = []

    def panel_fn(panel, pivot=True, act=None):
        shapes.append(panel.shape[0])
        return pk.panel_lu_plain(panel, pivot, act)

    g = np.random.default_rng(5).standard_normal((Mp, Np))
    tlk.blocked_getrf_tntpiv(torch.from_numpy(g), nb, chunk, panel_fn=panel_fn)
    steps, Mc = min(Mp, Np) // nb, max(shapes)
    want = sum(2.0 * M * nb * nb for M in shapes) + steps * (nb * nb * Np + 2.0 * Mc * nb * Np)
    fl = tlk.tntpiv_schedule_flops(Mp, Np, nb, chunk)
    assert fl["exec"] == want
    assert fl["model"] == Np * Np * (Mp - Np / 3.0)
    A = stt.Matrix.from_global(g, nb, grid=CPU)
    metrics.reset()
    metrics.on()
    try:
        stt.getrf(A, {"method_lu": "calu"})
        got = metrics.counters()
    finally:
        metrics.off()
        metrics.reset()
    assert got["factor.getrf.flops_exec"] == fl["exec"]
    assert got["factor.getrf.flops_model"] == fl["model"]


def test_panel_route_follows_the_device_and_dtype():
    assert tlk._panel_route(torch.float64, "cpu") is pk.panel_lu
    assert tlk._panel_route(torch.float32, "cuda") is pk.panel_lu
    assert tlk._panel_route(torch.complex128, "cuda") is pk.panel_lu_plain


def _pair(a, nb, grid11):
    return (st.Matrix.from_global(jnp.asarray(a), nb, grid=grid11),
            stt.Matrix.from_global(a, nb, grid=CPU))


@pytest.mark.parametrize("method", ["CALU", "BEAM"])
@pytest.mark.parametrize("m,n", [(100, 100), (100, 60), (60, 100)])
def test_getrf_calu_matches_jax(method, m, n, grid11):
    """n = 100 with nb = 16 (tests/test_lu.py::test_gesv_calu) and
    ragged m > n and m < n."""
    a = np.random.default_rng(m + 2 * n + len(method)).standard_normal((m, n))
    JA, TA = _pair(a, 16, grid11)
    JLU, jpiv, jinfo = st.getrf(JA, {st.Option.MethodLU: st.MethodLU[method]})
    TLU, tpiv, tinfo = stt.getrf(TA, {stt.Option.MethodLU: stt.MethodLU[method]})
    np.testing.assert_array_equal(tpiv.perm.numpy(), np.asarray(jpiv.perm))
    ref = np.asarray(JLU.to_global())
    np.testing.assert_allclose(TLU.to_global().numpy(), ref, rtol=0, atol=_tol(m, ref))
    assert int(tinfo) == int(jinfo) == 0
    # tournament pivoting keeps multipliers modest
    assert np.abs(np.tril(TLU.to_global().numpy(), -1)).max() < 4.0


@pytest.mark.parametrize("method", ["calu", "beam"])
def test_gesv_calu_matches_jax(method, grid11):
    n, nb = 100, 16
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal((n, n)), rng.standard_normal((n, 4))
    JA, TA = _pair(a, nb, grid11)
    JX, _, jpiv, jinfo = st.gesv(JA, st.Matrix.from_global(jnp.asarray(b), nb, grid=grid11),
                                 {"method_lu": method})
    TX, _, tpiv, tinfo = stt.gesv(TA, stt.Matrix.from_global(b, nb, grid=CPU),
                                  {"method_lu": method})
    np.testing.assert_array_equal(tpiv.perm.numpy(), np.asarray(jpiv.perm))
    ref = np.asarray(JX.to_global())
    got = TX.to_global().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(n, ref))
    assert int(tinfo) == 0
    err = checks.solve_residual(a, got, b)
    assert checks.passed(err, np.float64, factor=100), err


def test_getrf_calu_complex_and_singular_match_jax(grid11):
    n, nb = 64, 16
    rng = np.random.default_rng(13)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    JA, TA = _pair(a, nb, grid11)
    JLU, jpiv, _ = st.getrf(JA, {"method_lu": "calu"})
    TLU, tpiv, tinfo = stt.getrf(TA, {"method_lu": "calu"})
    np.testing.assert_array_equal(tpiv.perm.numpy(), np.asarray(jpiv.perm))
    ref = np.asarray(JLU.to_global())
    np.testing.assert_allclose(TLU.to_global().numpy(), ref, rtol=0, atol=_tol(n, ref))
    assert int(tinfo) == 0
    s = rng.standard_normal((n, n))
    s[:, 17] = 0.0
    JA, TA = _pair(s, nb, grid11)
    _, jpiv, jinfo = st.getrf(JA, {"method_lu": "calu"})
    _, tpiv, tinfo = stt.getrf(TA, {"method_lu": "calu"})
    np.testing.assert_array_equal(tpiv.perm.numpy(), np.asarray(jpiv.perm))
    assert int(tinfo) > 0 and int(jinfo) > 0


def test_getrf_calu_float32_matches_jax(grid11):
    n, nb = 96, 16
    a = np.random.default_rng(19).standard_normal((n, n)).astype(np.float32)
    JA, TA = _pair(a, nb, grid11)
    JLU, jpiv, _ = st.getrf(JA, {"method_lu": "calu"})
    TLU, tpiv, _ = stt.getrf(TA, {"method_lu": "calu"})
    np.testing.assert_array_equal(tpiv.perm.numpy(), np.asarray(jpiv.perm))
    ref = np.asarray(JLU.to_global())
    np.testing.assert_allclose(TLU.to_global().numpy(), ref, rtol=0,
                               atol=_tol(n, ref, np.float32))
