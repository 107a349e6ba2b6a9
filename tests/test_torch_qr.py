"""Port parity: the Householder pieces and the QR schedules of
slate_tpu_torch (``ops/householder.py``, ``ops/qr_fast.py``) against the
JAX package, on the CPU; the drivers are in test_torch_qr_drivers.py.

The same numpy inputs (seeded) go through both packages.  The pallas
schedule runs the JAX package's Pallas larft in interpret mode and this
package's plain version; the FLOP mirror and the schedule resolver are
pure Python and must agree exactly.  Both packages follow LAPACK's sign
convention (beta = -sign(alpha) ||x||), so the factors agree and not
just up to sign.  Tolerance: R, V, tau and T within ``1e-11 max|ref|``
in float64 (complex128 too)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.ops import householder as jh
from slate_tpu.ops import qr_fast as jq
from slate_tpu_torch.ops import householder as th
from slate_tpu_torch.ops import qr_fast as tq
from slate_tpu_torch.ops.hopper import panel_kernels as pk

torch.set_num_threads(1)

RTOL = 1e-11


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(float(np.abs(ref).max()), 1.0))


def _rand(m, n, seed, complex_=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    if complex_:
        a = a + 1j * rng.standard_normal((m, n))
    return a


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


@pytest.fixture(autouse=True)
def _no_launches():
    pk.reset_launches()
    yield
    assert all(v == 0 for v in pk.LAUNCHES.values()), pk.LAUNCHES  # CPU: plain versions


# ---------------------------------------------------------------------------
# householder.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha,xn", [(3.0, 4.0), (-2.0, 1.5), (0.0, 2.0), (1.5, 0.0),
                                      (0.0, 0.0), (1 - 2j, 3.0), (-0.5j, 0.0)])
def test_larfg_matches_jax(alpha, xn):
    dt = np.complex128 if isinstance(alpha, complex) else np.float64
    ref = jh._larfg(jnp.asarray(alpha, dt), jnp.asarray(xn), jnp.dtype(dt))
    got = th._larfg(torch.tensor(alpha, dtype=torch.complex128 if dt == np.complex128
                                 else torch.float64), torch.tensor(xn, dtype=torch.float64),
                    torch.complex128 if dt == np.complex128 else torch.float64)
    for g, r in zip(got, ref):
        assert g.dtype == (torch.complex128 if dt == np.complex128 else torch.float64)
        _close(g.numpy(), np.asarray(r), 1e-15)


@pytest.mark.parametrize("complex_", [False, True])
def test_householder_pieces_match_jax(complex_):
    a = _rand(60, 16, 1, complex_)
    fac, taus = jh.geqrf_blocked(jnp.asarray(a), 8)
    gfac, gtaus = th.geqrf_blocked(_t(a), 8)
    _close(gfac.numpy(), fac)
    _close(gtaus.numpy(), taus)
    for off in (0, 5):
        V = jh.materialize_v(fac, offset=off)
        gV = th.materialize_v(_t(np.asarray(fac)), offset=off)
        np.testing.assert_array_equal(gV.numpy(), np.asarray(V))
    V = jh.materialize_v(fac)
    T = jh.larft(V, taus)
    gT = th.larft(_t(np.asarray(V)), _t(np.asarray(taus)))
    _close(gT.numpy(), T)
    C = _rand(60, 9, 2, complex_)
    for trans in (False, True):
        ref = jh.apply_block_reflector(V, T, jnp.asarray(C), trans)
        got = th.apply_block_reflector(_t(np.asarray(V)), gT, _t(C), trans)
        _close(got.numpy(), ref)
    # the unblocked panel
    P, pt = jh._geqrf_panel(jnp.asarray(a[:, :8]))
    gP, gpt = th._geqrf_panel(_t(a[:, :8]))
    _close(gP.numpy(), P)
    _close(gpt.numpy(), pt)


def test_geqrf_dispatch_on_the_cpu_is_the_library():
    """householder.geqrf on the CPU is torch.geqrf (LAPACK), row-major,
    equal to the JAX package's vendor QR."""
    a = _rand(120, 80, 3)
    fac, taus = jh.geqrf(jnp.asarray(a))
    gfac, gtaus = th.geqrf(_t(a))
    assert gfac.is_contiguous()
    _close(gfac.numpy(), fac)
    _close(gtaus.numpy(), taus)


# ---------------------------------------------------------------------------
# qr_fast.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("complex_", [False, True])
def test_qr_panel_strips_matches_jax(complex_):
    a = _rand(96, 64, 4, complex_)
    P, taus = jq._qr_panel_strips(jnp.asarray(a), 16)
    gP, gtaus = tq._qr_panel_strips(_t(a), 16)
    _close(gP.numpy(), P)
    _close(gtaus.numpy(), taus)


def test_geqrf_fast_matches_jax():
    """n = 160 at nb = 32: five panels in coarse blocks of two, so the
    rolled panel loop and the coarse applies both run (strips of 8).
    ``geqrf_flat`` is held by the driver test's flat route."""
    a = _rand(170, 160, 5)
    F, taus = jq.geqrf_fast(jnp.asarray(a), 32, ib=8)
    gF, gtaus = tq.geqrf_fast(_t(a), 32, ib=8)
    _close(gF.numpy(), F)
    _close(gtaus.numpy(), taus)


@pytest.mark.parametrize("family", ["recursive", "pallas"])
@pytest.mark.parametrize("m,n", [(150, 100), (128, 50)])
def test_geqrf_recursive_matches_jax(family, m, n):
    """nb_switch = 32, strips of 8; (150, 100) is off the canonical
    lattice (zero pad to 192)."""
    a = _rand(m, n, m + n)
    F, taus = jq.geqrf_recursive(jnp.asarray(a), 32, 8, family)
    gF, gtaus = tq.geqrf_recursive(_t(a), 32, 8, family)
    _close(gF.numpy(), F)
    _close(gtaus.numpy(), taus)
    if family == "pallas":
        gF2, gt2 = tq.geqrf_pallas(_t(a), 32, 8)
        np.testing.assert_array_equal(gF2.numpy(), gF.numpy())
        np.testing.assert_array_equal(gt2.numpy(), gtaus.numpy())


def test_geqrf_recursive_complex_matches_jax():
    a = _rand(100, 70, 6, complex_=True)
    F, taus = jq.geqrf_recursive(jnp.asarray(a), 32, 8, "pallas")
    gF, gtaus = tq.geqrf_recursive(_t(a), 32, 8, "pallas")
    _close(gF.numpy(), F)
    _close(gtaus.numpy(), taus)


FLOP_GRID = list(itertools.product(
    [(256, 256), (1024, 1024), (2048, 2048), (4096, 4096), (3000, 2048), (32768, 16384),
     (6144, 2048), (2304, 1536)],
    [128, 512],                                           # nb
    ["flat", "recursive", "pallas", "vendor"],
    [64, 256],                                            # nb_switch
    [16, 32],                                             # ib
))


def test_geqrf_schedule_flops_equal_jax():
    for (m, n), nb, sched, nbs, ib in FLOP_GRID:
        for true in ((None, None), (m - 24, n - 24)):
            j = jq.geqrf_schedule_flops(m, n, nb, sched, nbs, ib, *true)
            t = tq.geqrf_schedule_flops(m, n, nb, sched, nbs, ib, *true)
            assert t == j, ((m, n), nb, sched, nbs, ib, true)


@pytest.mark.parametrize("sched", ["auto", "flat", "recursive", "pallas", "vendor"])
@pytest.mark.parametrize("m,n", [(100, 100), (1024, 1024), (2048, 2048), (2304, 1536),
                                 (32768, 16384), (1000, 2000), (3000, 1000)])
def test_resolve_qr_schedule_matches_jax_on_cpu(sched, m, n):
    got = tq.resolve_qr_schedule(m, n, torch.float64, sched, "cpu")
    assert got == jq.resolve_qr_schedule(m, n, sched)
    if sched == "auto":
        assert got == "vendor"


def test_resolve_qr_schedule_on_cuda_and_the_launch_mirror():
    def r(m, n, sched, device):
        return tq.resolve_qr_schedule(m, n, torch.float64, sched, device)

    assert r(32768, 16384, "auto", "cuda") == "pallas"
    assert r(4096, 4096, "auto", "cuda") == "pallas"
    assert r(2304, 1536, "auto", "cuda") == "flat"   # tiled, 1024 <= n < 2048
    assert r(1100, 1100, "auto", "cuda") == "vendor"  # not tiled
    assert r(1000, 2000, "auto", "cuda") == "vendor"  # wide
    assert r(6144, 2048, "pallas", "cpu") == "pallas"
    assert tq.geqrf_kernel_launches(16384, 256) == 64
    assert tq.geqrf_kernel_launches(2048, 256) == 8
    assert tq.geqrf_kernel_launches(200, 256) == 1
    assert tq._rec_widths(1000, 64) == jq._rec_widths(1000, 64)
