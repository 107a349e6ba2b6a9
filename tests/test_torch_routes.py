"""The schedule routes of slate_tpu_torch for dtypes the Hopper kernels do
not take, checked on the CPU with the device named ``"cuda"`` (the
resolvers only read the device's type, so no card is needed).

On a CUDA device the kernels take float32/float64 only, and each wrapper
raises for anything else (no fallback).  So a complex operand must never
be routed to the ``pallas`` family or the kernel solve phase: ``auto``
and explicit ``pallas`` run the same schedule as ``recursive`` (library
products, plain base cases), the solve phases take the library solve,
and the butterfly transform takes its plain level.  Real dtypes keep
their routes; the CPU keeps the JAX package's routes for every dtype
(tests/test_torch_chol.py, test_torch_lu.py, test_torch_qr.py)."""

import numpy as np
import pytest
import torch

from slate_tpu_torch.drivers import chol as tchol
from slate_tpu_torch.drivers import lu as tlu
from slate_tpu_torch.ops import chol_kernels as tck
from slate_tpu_torch.ops import lu_kernels as tlk
from slate_tpu_torch.ops import qr_fast as tq
from slate_tpu_torch.ops.hopper import panel_kernels as pk

REAL = [torch.float32, torch.float64]
COMPLEX = [torch.complex64, torch.complex128]
SCHEDULES = ["auto", "flat", "recursive", "pallas", "vendor"]


def _kernel_free(route: str) -> str:
    """What a route becomes for a dtype the kernels do not take."""
    return "recursive" if route == "pallas" else route


# the routes of float32/float64 on a CUDA device, as before the dtype
# reached the resolvers: (arguments, route)
CHOL_CUDA = [((4096, "auto"), "pallas"), ((2048, "auto"), "pallas"), ((1024, "auto"), "flat"),
             ((100, "pallas"), "pallas"), ((4096, "recursive"), "recursive"),
             ((4096, "flat"), "flat"), ((4096, "vendor"), "pallas"), ((1024, "vendor"), "flat")]
LU_CUDA = [((16384, 16384, "auto"), "pallas"), ((2048, 2048, "auto"), "pallas"),
           ((1024, 1024, "auto"), "vendor"), ((4096, 2048, "auto"), "vendor"),
           ((4096, 2048, "pallas"), "pallas"), ((2048, 2048, "recursive"), "recursive"),
           ((2048, 2048, "flat"), "flat_fast"), ((1000, 2000, "pallas"), "flat"),
           ((2048, 2048, "vendor"), "pallas")]
QR_CUDA = [((32768, 16384, "auto"), "pallas"), ((4096, 4096, "auto"), "pallas"),
           ((2304, 1536, "auto"), "flat"), ((1100, 1100, "auto"), "vendor"),
           ((1000, 2000, "auto"), "vendor"), ((6144, 2048, "pallas"), "pallas"),
           ((6144, 2048, "recursive"), "recursive"), ((2048, 2048, "flat"), "flat"),
           ((1000, 2000, "pallas"), "vendor")]
TRSM_CUDA = [((4096, "auto"), "pallas"), ((1024, "auto"), "vendor"),
             ((100, "pallas"), "pallas"), ((4096, "vendor"), "vendor")]


@pytest.mark.parametrize("dtype", REAL)
@pytest.mark.parametrize("args,route", CHOL_CUDA)
def test_chol_route_of_real_dtypes_on_cuda(dtype, args, route):
    n, sched = args
    assert tck.resolve_schedule(n, dtype, sched, "cuda") == route


@pytest.mark.parametrize("dtype", COMPLEX)
@pytest.mark.parametrize("args,route", CHOL_CUDA)
def test_chol_route_of_complex_dtypes_on_cuda(dtype, args, route):
    n, sched = args
    got = tck.resolve_schedule(n, dtype, sched, "cuda")
    assert got != "pallas" and got == _kernel_free(route)


@pytest.mark.parametrize("dtype", REAL)
@pytest.mark.parametrize("args,route", LU_CUDA)
def test_lu_route_of_real_dtypes_on_cuda(dtype, args, route):
    m, n, sched = args
    assert tlk.resolve_lu_schedule(m, n, dtype, sched, "cuda") == route


@pytest.mark.parametrize("dtype", COMPLEX)
@pytest.mark.parametrize("args,route", LU_CUDA)
def test_lu_route_of_complex_dtypes_on_cuda(dtype, args, route):
    m, n, sched = args
    got = tlk.resolve_lu_schedule(m, n, dtype, sched, "cuda")
    assert got != "pallas" and got == _kernel_free(route)


@pytest.mark.parametrize("dtype", REAL)
@pytest.mark.parametrize("args,route", QR_CUDA)
def test_qr_route_of_real_dtypes_on_cuda(dtype, args, route):
    m, n, sched = args
    assert tq.resolve_qr_schedule(m, n, dtype, sched, "cuda") == route


@pytest.mark.parametrize("dtype", COMPLEX)
@pytest.mark.parametrize("args,route", QR_CUDA)
def test_qr_route_of_complex_dtypes_on_cuda(dtype, args, route):
    m, n, sched = args
    got = tq.resolve_qr_schedule(m, n, dtype, sched, "cuda")
    assert got != "pallas" and got == _kernel_free(route)


@pytest.mark.parametrize("dtype", REAL + COMPLEX)
@pytest.mark.parametrize("args,route", TRSM_CUDA)
def test_solve_trsm_route_on_cuda(dtype, args, route):
    n, sched = args
    got = tchol._solve_trsm_route(n, dtype, sched, "cuda")
    assert got == (route if dtype in REAL else "vendor")


@pytest.mark.parametrize("dtype", REAL + COMPLEX)
@pytest.mark.parametrize("sched", SCHEDULES)
def test_cpu_routes_do_not_depend_on_the_dtype(dtype, sched):
    """On the CPU every wrapper runs its plain version, so the routes are
    the JAX package's for every dtype."""
    f64 = torch.float64
    assert tck.resolve_schedule(4096, dtype, sched, "cpu") == \
        tck.resolve_schedule(4096, f64, sched, "cpu")
    assert tlk.resolve_lu_schedule(2048, 2048, dtype, sched, "cpu") == \
        tlk.resolve_lu_schedule(2048, 2048, f64, sched, "cpu")
    assert tq.resolve_qr_schedule(6144, 2048, dtype, sched, "cpu") == \
        tq.resolve_qr_schedule(6144, 2048, f64, sched, "cpu")
    assert tchol._solve_trsm_route(4096, dtype, sched, "cpu") == \
        tchol._solve_trsm_route(4096, f64, sched, "cpu")


def test_kernels_take_only_real_dtypes_on_cuda():
    for dt in REAL:
        assert pk.kernels_take(dt, "cuda") and pk.kernels_take(dt, "cpu")
    for dt in COMPLEX + [torch.float16]:
        assert not pk.kernels_take(dt, "cuda") and pk.kernels_take(dt, "cpu")


def _raise(*args, **kwargs):
    raise AssertionError("the butterfly_level wrapper was called")


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_apply_butterfly_takes_the_plain_level_for_complex(monkeypatch, dtype):
    rng = np.random.default_rng(5)
    n, w, depth = 32, 3, 2
    x = (rng.standard_normal((n, w)) + 1j * rng.standard_normal((n, w))).astype(dtype)
    d = np.exp(rng.uniform(-1, 1, (depth, n)) / 10).astype(dtype)
    X, D = torch.from_numpy(x), torch.from_numpy(d)
    want = tlu._apply_butterfly(X, D, transpose=True)
    monkeypatch.setattr(pk, "butterfly_level", _raise)
    for transpose in (True, False):
        got = tlu._apply_butterfly(X, D, transpose=transpose)
        ref = X
        levels = range(depth) if transpose else range(depth - 1, -1, -1)
        for ell in levels:
            ref = pk.butterfly_level_plain(ref, D[ell], n // (2 * 2**ell), transpose)
        assert torch.equal(got, ref)
    assert torch.equal(tlu._apply_butterfly(X, D, transpose=True), want)


def test_apply_butterfly_takes_the_wrapper_for_real_dtypes(monkeypatch):
    X = torch.zeros(16, 2, dtype=torch.float64)
    D = torch.ones(1, 16, dtype=torch.float64)
    monkeypatch.setattr(pk, "butterfly_level", _raise)
    with pytest.raises(AssertionError, match="wrapper was called"):
        tlu._apply_butterfly(X, D, transpose=True)


# -- the mesh factorizations' tile and panel routes (spmd_chol, spmd_lu,
#    spmd_qr); their reach through the SPMD bodies is counted in
#    tests/test_torch_spmd_factor.py::test_spmd_bodies_reach_the_kernel_routes


@pytest.mark.parametrize("sched", ["auto", "flat", "recursive", "pallas"])
@pytest.mark.parametrize("dtype", REAL + COMPLEX)
def test_spmd_chol_tile_route(dtype, sched):
    """The mesh Cholesky's diagonal tile: the hand-kernel family for a
    float32/float64 tile on a CUDA device, the library on the CPU and for
    complex tiles; a schedule family the caller names wins (``pallas``
    of a complex tile runs as ``recursive`` inside ``cholesky``)."""
    from slate_tpu_torch.parallel import spmd_chol

    auto_cuda = "pallas" if dtype in REAL else "vendor"
    want_cuda = auto_cuda if sched == "auto" else sched
    assert spmd_chol.tile_route(dtype, "cuda", sched) == want_cuda
    assert spmd_chol.tile_route(dtype, "cpu", sched) == ("vendor" if sched == "auto" else sched)


@pytest.mark.parametrize("dtype", REAL + COMPLEX)
def test_spmd_lu_and_qr_panel_routes(dtype):
    """The mesh LU's panels go through ``lu_kernels._panel_route`` and the
    mesh QR's T through ``spmd_qr.larft_route``: the ``panel_lu`` and
    ``larft`` wrappers on a CUDA device for a dtype they take, the plain
    versions for complex; on the CPU the wrappers, which run their plain
    versions there."""
    from slate_tpu_torch.parallel import spmd_qr
    from slate_tpu_torch.ops import householder

    real = dtype in REAL
    assert tlk._panel_route(dtype, "cuda") is (pk.panel_lu if real else pk.panel_lu_plain)
    assert spmd_qr.larft_route(dtype, "cuda") is (pk.larft if real else householder.larft)
    assert tlk._panel_route(dtype, "cpu") is pk.panel_lu
    assert spmd_qr.larft_route(dtype, "cpu") is pk.larft


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("rows", [512, 16384, 32768])
def test_panel_lu_plan_fits_the_mesh_panels(rows, itemsize):
    """The mesh LU's widest panels, (m - k 512, 512) up to 16384 rows (and
    32768), fit one cooperative panel_lu launch on an H100 (132 SMs, the
    227 KiB a block may use): no split of the panel is needed."""
    plan = pk.panel_lu_plan(rows, 512, itemsize, 132, pk._MAX_SMEM)
    assert plan.grid * plan.rows >= rows and plan.strip >= 1
