"""The serve tier of slate_tpu_torch on the CPU: the service-level cases
of tests/test_serve.py, tests/test_factor_cache.py and
tests/test_chaos.py run on the port and held to the same assertions
(the JAX package's counters are the spec), plus one cross-package
stream and the checks of what is not ported yet.

Every service here is built on a CPU placement
(``PlacementPolicy(devices=["cpu"])``): without it the port serves on
``cuda:0`` and raises where there is none.  Small buckets (floor 16,
nrhs floor 4); the ``auto`` schedule takes the library on the CPU and
``pallas`` the kernels' plain versions.  Results are held to 200 n eps
relative of the JAX package's ``direct_call`` on the same numpy
operands.  The breaker is driven by rewinding ``opened_at``, never by
waiting out a cooldown."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from slate_tpu.serve import cache as jcache
from slate_tpu.serve import factor_cache as jfc
from slate_tpu.serve import service as jservice
from slate_tpu_torch import serve
from slate_tpu_torch.aux import faults, metrics, spans
from slate_tpu_torch.exceptions import (DistributedException, InvalidInput,
                                        NumericalError, SlateError)
from slate_tpu_torch.ops.hopper import panel_kernels as pk
from slate_tpu_torch.serve import buckets as bk
from slate_tpu_torch.serve.cache import ExecutableCache, direct_call
from slate_tpu_torch.serve.factor_cache import FactorCache, matrix_fingerprint
from slate_tpu_torch.serve.placement import PlacementPolicy
from slate_tpu_torch.serve.service import DeadlineExceeded, Rejected, SolverService

torch.set_num_threads(1)

FLOOR, NRHS_FLOOR = 16, 4


@pytest.fixture(autouse=True)
def _env():
    """Metrics on (the counters are the contract), faults and spans off
    before and after, and no kernel launched (the CPU runs the plain
    versions)."""
    metrics.off()
    metrics.reset()
    metrics.on()
    faults.reset()
    pk.reset_launches()
    yield
    metrics.off()
    metrics.reset()
    faults.reset()
    spans.off()
    spans.clear()
    assert all(v == 0 for v in pk.LAUNCHES.values()), pk.LAUNCHES


@pytest.fixture(scope="module")
def shared_cache():
    return ExecutableCache(manifest_path=None)


def _cpu():
    return PlacementPolicy(devices=["cpu"])


def _svc(cache, **kw):
    kw.setdefault("batch_max", 4)
    kw.setdefault("batch_window_s", 0.002)
    kw.setdefault("dim_floor", FLOOR)
    kw.setdefault("nrhs_floor", NRHS_FLOOR)
    kw.setdefault("placement", _cpu())
    return SolverService(cache=cache, **kw)


def _tol(dtype, n):
    return 200 * n * np.finfo(np.dtype(dtype)).eps


def _rel(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _gesv_prob(n, seed=0, nrhs=2, dtype=np.float64):
    r = np.random.default_rng(seed)
    return ((r.standard_normal((n, n)) + n * np.eye(n)).astype(dtype),
            r.standard_normal((n, nrhs)).astype(dtype))


def _posv_prob(n, seed=0, nrhs=2, dtype=np.float64):
    r = np.random.default_rng(seed)
    G = r.standard_normal((n, n))
    return (G @ G.T + n * np.eye(n)).astype(dtype), r.standard_normal((n, nrhs)).astype(dtype)


# ---------------------------------------------------------------------------
# pad correctness against the JAX package's direct driver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["auto", "pallas"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,nrhs", [(10, 2), (20, 3)])
def test_pad_correctness_gesv(shared_cache, schedule, dtype, n, nrhs):
    A, B = _gesv_prob(n, seed=n, nrhs=nrhs, dtype=dtype)
    s = _svc(shared_cache, schedule=schedule)
    try:
        got = s.submit("gesv", A, B).result(timeout=120)
    finally:
        s.stop()
    ref = jcache.direct_call("gesv", A, B)
    assert got.shape == (n, nrhs) and got.dtype == A.dtype
    assert _rel(got, ref) < _tol(dtype, n)


@pytest.mark.parametrize("schedule", ["auto", "pallas"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pad_correctness_posv(shared_cache, schedule, dtype):
    n = 20
    A, B = _posv_prob(n, seed=7, nrhs=3, dtype=dtype)
    s = _svc(shared_cache, schedule=schedule)
    try:
        got = s.submit("posv", A, B).result(timeout=120)
    finally:
        s.stop()
    assert _rel(got, jcache.direct_call("posv", A, B)) < _tol(dtype, n)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n", [(24, 24), (40, 12)])
def test_pad_correctness_gels(shared_cache, dtype, m, n):
    rng = np.random.default_rng(m + n)
    A = rng.standard_normal((m, n)).astype(dtype)
    B = rng.standard_normal((m, 2)).astype(dtype)
    s = _svc(shared_cache)
    try:
        got = s.submit("gels", A, B).result(timeout=120)
    finally:
        s.stop()
    assert got.shape == (n, 2)
    assert _rel(got, jcache.direct_call("gels", A, B)) < _tol(dtype, m)


def test_gels_underdetermined_direct(shared_cache):
    rng = np.random.default_rng(3)
    A = rng.standard_normal((10, 30))
    B = rng.standard_normal((10, 2))
    s = _svc(shared_cache)
    with metrics.deltas() as d:
        got = s.submit("gels", A, B).result(timeout=120)
    s.stop()
    assert np.abs(got - np.linalg.lstsq(A, B, rcond=None)[0]).max() < 1e-8
    assert d.get("serve.direct_only") == 1 and d.get("serve.fallbacks") == 0


def test_mixed_precision_bucket(shared_cache):
    n = 20
    A, B = _gesv_prob(n, seed=21)
    s = _svc(shared_cache)
    try:
        X = s.submit("gesv", A, B, precision="mixed").result(timeout=120)
    finally:
        s.stop()
    assert np.abs(X - np.linalg.solve(A, B)).max() < 1e-9


# ---------------------------------------------------------------------------
# coalescing, deadlines, backpressure, failures
# ---------------------------------------------------------------------------


def test_coalescing_batches_same_bucket(shared_cache):
    rng = np.random.default_rng(1)
    n = 10
    B = rng.standard_normal((n, 2))
    mats = [rng.standard_normal((n, n)) + n * np.eye(n) for _ in range(6)]
    s = _svc(shared_cache, start=False)
    with metrics.deltas() as d:
        futs = [s.submit("gesv", A, B) for A in mats]
        s.start()
        out = [f.result(timeout=120) for f in futs]
    s.stop()
    assert d.get("serve.batched") >= 1
    assert d.get("serve.batched_requests") >= 4
    for A, X in zip(mats, out):
        assert np.abs(A @ X - B).max() < 1e-9


def test_warm_stream_makes_no_cold_build(shared_cache, tmp_path):
    """The steady-state rule: after warmup() of a captured manifest, a
    stream in warmed buckets makes no cold build (jit.compilations flat)."""
    A1, B1 = _gesv_prob(10, seed=30)
    A2, B2 = _posv_prob(20, seed=31, nrhs=3)
    manifest = str(tmp_path / "warmup.json")
    s1 = _svc(shared_cache, start=False)
    futs = [s1.submit("gesv", A1 + i * 0.01 * np.eye(10), B1) for i in range(4)]
    futs.append(s1.submit("posv", A2, B2))
    s1.start()
    for f in futs:
        f.result(timeout=120)
    s1.stop()
    shared_cache.save_manifest(manifest)
    cache2 = ExecutableCache(manifest_path=None)
    s2 = _svc(cache2, start=False)
    with metrics.deltas() as d:
        assert s2.warmup(manifest) >= 4  # both batch points of both buckets
        assert d.get("jit.compilations") >= 4
    with metrics.deltas() as d:
        futs = []
        for i in range(6):
            futs.append(s2.submit("gesv", A1 + i * 1e-3 * np.eye(10), B1))
            futs.append(s2.submit("posv", A2 + i * 1e-3 * np.eye(20), B2))
        s2.start()
        for f in futs:
            f.result(timeout=120)
        got = s2.submit("gesv", A1, B1).result(timeout=120)  # the b1 point
        assert d.get("serve.requests") == 13
        assert d.get("jit.compilations") == 0, "steady state must not cold-build"
        assert d.get("serve.batched") >= 1 and d.get("serve.bucket_pad_waste") > 0
    s2.stop()
    assert np.abs(A1 @ got - B1).max() < 1e-9


def test_deadline_miss_cancels_queued_request(shared_cache):
    A, B = _gesv_prob(10, seed=2, nrhs=1)
    s = _svc(shared_cache, batch_max=2, start=False)
    with metrics.deltas() as d:
        fut = s.submit("gesv", A, B, deadline=0.01)
        time.sleep(0.05)  # expires while the worker is paused
        s.start()
        with pytest.raises(DeadlineExceeded) as ei:
            fut.result(timeout=120)
        assert d.get("serve.deadline_miss") == 1
        assert d.get("serve.deadline_miss_queued") == 1
        assert d.get("serve.deadline_miss_late") == 0
    assert ei.value.routine == "gesv" and ei.value.bucket == "gesv.16x16x4.float64"
    s.stop()


def test_queue_full_rejected_with_context(shared_cache):
    A, B = _gesv_prob(10, seed=4, nrhs=1)
    s = _svc(shared_cache, max_queue=2, start=False)
    f1 = s.submit("gesv", A, B)
    f2 = s.submit("gesv", A, B)
    with metrics.deltas() as d:
        with pytest.raises(Rejected) as ei:
            s.submit("gesv", A, B)
        assert d.get("serve.rejected") == 1
    assert ei.value.routine == "gesv"
    s.start()
    assert f1.result(timeout=120).shape == (10, 1)
    assert f2.result(timeout=120).shape == (10, 1)
    s.stop()


def test_stop_resolves_pending_futures(shared_cache):
    A, B = _gesv_prob(10, seed=5, nrhs=1)
    s = _svc(shared_cache, start=False)
    fut = s.submit("gesv", A, B)
    s.stop()
    with pytest.raises(Rejected) as ei:
        fut.result(timeout=10)
    assert ei.value.bucket == "gesv.16x16x4.float64" and "[routine=gesv" in str(ei.value)
    with pytest.raises(Rejected):
        s.submit("gesv", A, B)  # stopped: no worker would resolve it


def test_stop_drain_finishes_admitted_work(shared_cache):
    A, B = _gesv_prob(10, seed=6, nrhs=1)
    s = _svc(shared_cache)
    futs = [s.submit("gesv", A + i * 1e-3 * np.eye(10), B) for i in range(3)]
    with metrics.deltas() as d:
        s.stop(drain=True, drain_timeout=60)
        assert d.get("serve.drain_abandoned") == 0
    for f in futs:
        assert np.all(np.isfinite(f.result(timeout=10)))


class _FlakyCache(ExecutableCache):
    """Fails the batched path a fixed number of times, then heals."""

    def __init__(self, fail_times):
        super().__init__(manifest_path=None)
        self.fail_times = fail_times
        self.calls = 0

    def run(self, key, A_batch, B_batch, device=None):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise RuntimeError("injected batched failure")
        return super().run(key, A_batch, B_batch, device=device)


def test_retry_then_fallback_and_degrade():
    A, B = _gesv_prob(10, seed=6, nrhs=1)
    fc = _FlakyCache(fail_times=10**6)
    s = _svc(fc, batch_max=2, degrade_after=2)
    with metrics.deltas() as d:
        X = s.submit("gesv", A, B, retries=1).result(timeout=120)
        assert np.abs(A @ X - B).max() < 1e-9  # the fallback result is real
        assert fc.calls == 2  # first try + one retry
        assert d.get("serve.fallbacks") == 1
        assert d.get("serve.degraded") == 1
        X2 = s.submit("gesv", A, B).result(timeout=120)
        assert fc.calls == 2  # open: straight to the direct driver
        assert d.get("serve.fallbacks") == 2
        assert np.abs(A @ X2 - B).max() < 1e-9
    s.stop()


def test_breaker_opens_half_opens_closes():
    A, B = _gesv_prob(10, seed=6, nrhs=1)
    hc = _FlakyCache(fail_times=2)
    s = _svc(hc, breaker_cooldown_s=60.0)
    key = bk.bucket_for("gesv", 10, 10, 1, A.dtype, floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    with metrics.deltas() as d:
        X = s.submit("gesv", A, B, retries=1).result(timeout=120)
        assert np.abs(A @ X - B).max() < 1e-8
        assert d.get("serve.breaker_open") == 1
        assert s.health()["breakers"][key.label] == bk.BREAKER_OPEN
        assert s.health()["open_buckets"] == [key.label]
        calls = hc.calls
        s.submit("gesv", A, B).result(timeout=120)
        assert hc.calls == calls  # open: the batched path is not touched
        s._breakers[key].opened_at -= 61.0  # "elapse" the cooldown
        X3 = s.submit("gesv", A, B).result(timeout=120)
        assert np.abs(A @ X3 - B).max() < 1e-8
        assert hc.calls == calls + 1  # the probe went batched
        assert d.get("serve.breaker_half_open") == 1
        assert d.get("serve.breaker_closed") == 1
        assert s.health()["breakers"][key.label] == bk.BREAKER_CLOSED
    s.stop()


def test_posv_not_spd_raises_numerical(shared_cache):
    s = _svc(shared_cache)
    with pytest.raises(NumericalError):
        s.submit("posv", -np.eye(10), np.ones((10, 1))).result(timeout=120)
    s.stop()


def test_bad_shapes_and_inputs_refused_at_submit(shared_cache):
    s = _svc(shared_cache)
    with pytest.raises(ValueError):
        s.submit("gesv", np.ones((4, 5)), np.ones((4, 1)))
    with pytest.raises(ValueError):
        s.submit("gesv", np.ones((4, 4)), np.ones((3, 1)))
    with pytest.raises(ValueError):
        s.submit("gesv", np.eye(4), np.ones((4, 1)), priority="urgent")
    A, B = _gesv_prob(10, seed=8)
    Abad = A.copy()
    Abad[3, 3] = np.nan
    with metrics.deltas() as d:
        with pytest.raises(InvalidInput) as ei:
            s.submit("gesv", Abad, B)
        assert d.get("serve.invalid_input") == 1 and d.get("serve.requests") == 0
    assert ei.value.routine == "gesv"
    s.stop()


def test_warmup_env_manifest_records(tmp_path, monkeypatch):
    path = str(tmp_path / "m.json")
    monkeypatch.setenv("SLATE_TPU_WARMUP", path)
    c = ExecutableCache()
    assert c.manifest_path == path
    key = bk.bucket_for("gesv", 10, 10, 1, np.float64, floor=FLOOR)
    c.ensure_manifest(key, (1,))
    assert os.path.exists(path)
    assert (key, 1) in ExecutableCache(manifest_path=path).entries()
    # the JAX package reads the port's manifest, and the port the JAX package's
    assert (key.to_json(), 1) in [(k.to_json(), b) for k, b in
                                  jcache.ExecutableCache(manifest_path=path).entries()]


def test_corrupt_manifest_counts_and_warns_once(tmp_path):
    path = str(tmp_path / "broken.json")
    with open(path, "w") as f:
        f.write('{"version": 1, "entries": [{"routine": "gesv"')
    with metrics.deltas() as d:
        with pytest.warns(RuntimeWarning, match="broken.json"):
            c = ExecutableCache(manifest_path=path)
        assert c.entries() == []
        assert ExecutableCache(manifest_path=path).entries() == []
    assert d.get("serve.manifest_corrupt") == 2


def test_api_singleton_and_options():
    svc = serve.configure({"serve_queue_limit": 7}, dim_floor=FLOOR, nrhs_floor=NRHS_FLOOR,
                          placement=_cpu())
    try:
        assert svc.max_queue == 7 and serve.get_service() is svc
        assert serve.get_cache() is svc.cache and serve.get_factor_cache() is None
        A, B = _gesv_prob(10, seed=9)
        assert np.abs(A @ serve.gesv(A, B) - B).max() < 1e-9
        assert serve.wait_ready() and serve.health()["ready"]
        assert serve.invalidate("x" * 64) is False and serve.invalidate_all() == 0
        assert serve.update_factor("x" * 64, A, B[:, 0]) is None
    finally:
        serve.shutdown()


def test_api_factor_cache_lifecycle():
    serve.configure({"serve_factor_cache": True}, dim_floor=FLOOR, nrhs_floor=NRHS_FLOOR,
                    placement=_cpu())
    try:
        A, B = _posv_prob(12, seed=10)
        serve.posv(A, B)
        fp = serve.factor_fingerprint("posv", A)
        assert serve.get_factor_cache().get(fp) is not None
        u = np.random.default_rng(11).standard_normal(12)
        fp2 = serve.update_factor(fp, A + np.outer(u, u), u)
        with metrics.deltas() as d:
            X = serve.posv(A + np.outer(u, u), B)
            assert d.get("serve.factor_cache.hit") == 1
        assert np.abs(X - np.linalg.solve(A + np.outer(u, u), B)).max() < 1e-9
        assert serve.invalidate(fp2) and serve.invalidate_all() == 0
    finally:
        serve.shutdown()


# ---------------------------------------------------------------------------
# the factor cache, end to end
# ---------------------------------------------------------------------------


def test_factor_cache_disabled_by_default(shared_cache, monkeypatch):
    monkeypatch.delenv("SLATE_TPU_FACTOR_CACHE", raising=False)
    s = _svc(shared_cache)
    try:
        assert s.factor_cache is None
        A, B = _gesv_prob(12, seed=6)
        with metrics.deltas() as d:
            X = s.submit("gesv", A, B).result(timeout=120)
            assert not d.get("serve.factor_cache.miss") and not d.get("serve.factor_cache.hit")
        assert np.abs(X - np.linalg.solve(A, B)).max() < 1e-9
        assert s.health()["factor_cache"] is None
    finally:
        s.stop()


@pytest.mark.parametrize("schedule", ["auto", "pallas"])
def test_acceptance_repeated_A_stream(shared_cache, schedule):
    fc = FactorCache(max_entries=8)
    s = _svc(shared_cache, factor_cache=fc, schedule=schedule)
    try:
        A, B0 = _gesv_prob(12, seed=7)
        with metrics.deltas() as d:
            X0 = s.submit("gesv", A, B0).result(timeout=120)
            assert d.get("serve.factor_cache.miss") == 1
        assert np.abs(X0 - np.linalg.solve(A, B0)).max() < 1e-9
        s.warmup()  # the miss registered the solve bucket
        rng = np.random.default_rng(8)
        Bs = [rng.standard_normal((12, 2)) for _ in range(20)]
        with metrics.deltas() as d:
            futs = [s.submit("gesv", A, B) for B in Bs]
            Xs = [f.result(timeout=120) for f in futs]
            assert d.get("serve.factor_cache.hit") >= 19
            assert d.get("jit.compilations") == 0
        for B, X in zip(Bs, Xs):
            assert np.abs(X - np.linalg.solve(A, B)).max() < 1e-9
        assert s.health()["factor_cache"]["entries"] == 1
    finally:
        s.stop()


def test_posv_hit_parity(shared_cache):
    s = _svc(shared_cache, factor_cache=FactorCache(max_entries=8))
    try:
        A, B = _posv_prob(12, seed=9)
        s.submit("posv", A, B).result(timeout=120)
        s.warmup()
        with metrics.deltas() as d:
            X = s.submit("posv", A, B).result(timeout=120)
            assert d.get("serve.factor_cache.hit") == 1
        assert _rel(X, jcache.direct_call("posv", A, B)) < _tol(np.float64, 12)
    finally:
        s.stop()


def test_eviction_tight_byte_budget_counted_refactor(shared_cache):
    fc = FactorCache(max_entries=8, max_bytes=64)  # no factor fits
    s = _svc(shared_cache, factor_cache=fc)
    try:
        A, _ = _gesv_prob(12, seed=10)
        rng = np.random.default_rng(11)
        with metrics.deltas() as d:
            for _ in range(3):
                B = rng.standard_normal((12, 2))
                X = s.submit("gesv", A, B).result(timeout=120)
                assert np.abs(X - np.linalg.solve(A, B)).max() < 1e-9
            assert d.get("serve.factor_cache.hit") == 0
            assert d.get("serve.factor_cache.miss") == 3
            assert d.get("serve.factor_cache.uncacheable") == 3
        assert len(fc) == 0
    finally:
        s.stop()


def test_invalidation_falls_back_counted(shared_cache):
    fc = FactorCache(max_entries=8)
    s = _svc(shared_cache, factor_cache=fc)
    try:
        A, B = _gesv_prob(12, seed=12)
        s.submit("gesv", A, B).result(timeout=120)
        s.warmup()
        assert fc.invalidate(matrix_fingerprint(A, "gesv", schedule=s.schedule))
        with metrics.deltas() as d:
            X = s.submit("gesv", A, B).result(timeout=120)
            assert d.get("serve.factor_cache.miss") == 1 and d.get("serve.factor_cache.hit") == 0
        assert np.abs(X - np.linalg.solve(A, B)).max() < 1e-9
        with metrics.deltas() as d:
            s.submit("gesv", A, B).result(timeout=120)
            assert d.get("serve.factor_cache.hit") == 1
    finally:
        s.stop()


def test_factor_stale_chaos_revalidates(shared_cache):
    s = _svc(shared_cache, factor_cache=FactorCache(max_entries=8))
    try:
        A, B = _gesv_prob(12, seed=13)
        s.submit("gesv", A, B).result(timeout=120)
        s.warmup()
        faults.arm("factor_stale", once=True)
        faults.on()
        with metrics.deltas() as d:
            X = s.submit("gesv", A, B).result(timeout=120)
            assert d.get("serve.factor_cache.stale") == 1
            assert d.get("faults.injected.factor_stale") == 1
        assert np.abs(X - np.linalg.solve(A, B)).max() < 1e-9
    finally:
        s.stop()


def test_spill_on_open_breaker(shared_cache):
    fc = FactorCache(max_entries=8)
    s = _svc(shared_cache, factor_cache=fc)
    try:
        A, B = _gesv_prob(12, seed=14)
        s.submit("gesv", A, B).result(timeout=120)
        s.warmup()
        skey = fc.get(matrix_fingerprint(A, "gesv", schedule=s.schedule)).solve_key
        br = s._breaker(s._replicas[0], skey)
        br.state = bk.BREAKER_OPEN
        br.opened_at = time.monotonic()

        def runs():
            return sum(v["count"] for k, v in metrics.timers().items()
                       if k.startswith(f"serve.{skey.label}.b") and k.endswith(".run"))

        runs0 = runs()
        with metrics.deltas() as d:
            X = s.submit("gesv", A, B).result(timeout=120)
            assert d.get("serve.factor_cache.spill") == 1
        assert runs() == runs0  # the solve executable never ran
        assert np.abs(X - np.linalg.solve(A, B)).max() < 1e-9
        br.state = bk.BREAKER_CLOSED
    finally:
        s.stop()


def test_hit_with_different_nrhs_bucket(shared_cache):
    s = _svc(shared_cache, factor_cache=FactorCache(max_entries=8))
    try:
        A, B2 = _gesv_prob(12, seed=18, nrhs=2)
        s.submit("gesv", A, B2).result(timeout=120)
        s.warmup()
        B8 = np.random.default_rng(19).standard_normal((12, 7))
        with metrics.deltas() as d:
            X = s.submit("gesv", A, B8).result(timeout=120)
            assert d.get("serve.factor_cache.hit") == 1 and d.get("serve.breaker_open") == 0
        assert np.abs(X - np.linalg.solve(A, B8)).max() < 1e-9
    finally:
        s.stop()


def test_gels_factors_once_then_hits(shared_cache):
    fc = FactorCache(max_entries=8)
    s = _svc(shared_cache, factor_cache=fc)
    try:
        rng = np.random.default_rng(15)
        A = rng.standard_normal((20, 12))
        B = rng.standard_normal((20, 2))
        with metrics.deltas() as d:
            X0 = s.submit("gels", A, B).result(timeout=120)
            assert d.get("serve.factor_cache.miss") == 1
        assert len(fc) == 1
        B2 = rng.standard_normal((20, 2))
        with metrics.deltas() as d:
            X1 = s.submit("gels", A, B2).result(timeout=120)
            assert d.get("serve.factor_cache.hit") == 1
        assert np.abs(X0 - np.linalg.lstsq(A, B, rcond=None)[0]).max() < 1e-9
        assert np.abs(X1 - np.linalg.lstsq(A, B2, rcond=None)[0]).max() < 1e-9
    finally:
        s.stop()


def test_same_A_burst_factors_once(shared_cache):
    fc = FactorCache(max_entries=8)
    s = _svc(shared_cache, factor_cache=fc, start=False)
    try:
        A, _ = _gesv_prob(12, seed=16)
        rng = np.random.default_rng(17)
        futs = [s.submit("gesv", A, rng.standard_normal((12, 2))) for _ in range(4)]
        s.start()
        for f in futs:
            assert np.all(np.isfinite(f.result(timeout=120)))
        c = metrics.counters()
        assert c.get("serve.factor_cache.hit", 0) >= 1
        assert c.get("serve.factor_cache.miss") == 4
        assert len(fc) == 1
    finally:
        s.stop()


def test_cross_package_repeated_A_stream():
    """The same 12-request repeated-A stream (one miss, eleven hits, and
    one refused non-finite B) through the JAX package's SolverService
    and the port's: per-request X within 200 n eps, and the timing-free
    counters equal."""
    from slate_tpu.aux import metrics as jmetrics

    n = 12
    A, B0 = _gesv_prob(n, seed=40)
    rng = np.random.default_rng(41)
    Bs = [B0] + [rng.standard_normal((n, 1 + i % 3)) for i in range(11)]
    Bbad = Bs[3].copy()
    Bbad[0, 0] = np.inf
    names = ("serve.factor_cache.hit", "serve.factor_cache.miss",
             "serve.factor_cache.refactor", "serve.bucket_pad_waste",
             "serve.invalid_input", "serve.requests")

    def drive(svc, mets, exc):
        out = []
        with mets.deltas() as d:
            for i, B in enumerate(Bs):
                out.append(svc.submit("gesv", A, B).result(timeout=300))
                if i == 3:
                    with pytest.raises(exc):
                        svc.submit("gesv", A, Bbad)
            counts = {k: d.get(k) for k in names}
        svc.stop()
        return out, counts

    jmetrics.off()
    jmetrics.reset()
    jmetrics.on()
    try:
        jsvc = jservice.SolverService(
            cache=jcache.ExecutableCache(manifest_path=None),
            factor_cache=jfc.FactorCache(max_entries=8), batch_max=4,
            batch_window_s=0.002, dim_floor=FLOOR, nrhs_floor=NRHS_FLOOR)
        from slate_tpu.exceptions import InvalidInput as JInvalid

        jX, jcounts = drive(jsvc, jmetrics, JInvalid)
    finally:
        jmetrics.off()
        jmetrics.reset()
    tX, tcounts = drive(_svc(ExecutableCache(), factor_cache=FactorCache(max_entries=8)),
                        metrics, InvalidInput)
    assert tcounts == jcounts
    assert tcounts["serve.factor_cache.hit"] == 11 and tcounts["serve.factor_cache.miss"] == 1
    for t, j in zip(tX, jX):
        assert t.shape == j.shape and _rel(t, j) < _tol(np.float64, n)


# ---------------------------------------------------------------------------
# faults on the port's sites
# ---------------------------------------------------------------------------


def test_fault_spec_grammar_and_triggers():
    faults.configure("execute:p=0.5,seed=3; latency:once,after=4,ms=2.5 ;worker_death:every=4")
    assert set(faults.stats()) == {"execute", "latency", "worker_death"}
    # the admission plane's site takes the burst= key; the fleet sites
    # arm like any other
    for bad in ("nosite:p=0.1", "execute:bogus=1", "execute", "host_death:bogus=1"):
        with pytest.raises(ValueError):
            faults.configure(bad)
    fleet = ("host_death", "host_partition", "rpc_timeout")
    faults.configure("host_death:once;host_partition:every=2;rpc_timeout:p=0.5,seed=1")
    assert set(fleet) <= set(faults.stats())
    for site in fleet:
        faults.disarm(site)
    faults.configure("tenant_flood:once,burst=5")
    assert faults._sites["tenant_flood"].burst == 5
    faults.disarm("tenant_flood")
    faults.on()
    assert [faults.fire("latency") is not None for _ in range(6)] == \
        [False, False, False, True, False, False]
    assert [faults.fire("worker_death") is not None for _ in range(8)] == \
        [False, False, False, True] * 2
    x = np.ones((2, 2))
    faults.arm("factor_stale", once=True)
    y = faults.perturb("factor_stale", x)
    assert y[0, 0] == 3.0 and x[0, 0] == 1.0  # a fresh copy, finite and wrong
    t = torch.ones(3, dtype=torch.float64)
    faults.arm("factor_stale", once=True)
    assert faults.perturb("factor_stale", t)[0] == 3.0 and t[0] == 1.0


def test_execute_fault_retries_with_backoff(shared_cache):
    A, B = _gesv_prob(10, seed=20)
    faults.arm("execute", once=True)
    faults.on()
    s = _svc(shared_cache)
    with metrics.deltas() as d:
        X = s.submit("gesv", A, B, retries=1).result(timeout=120)
        assert np.all(np.isfinite(X))
        assert d.get("serve.retries") == 1 and d.get("faults.injected.execute") == 1
        assert d.get("serve.fallbacks") == 0
    t = metrics.timers().get("serve.retry_backoff_s")
    assert t is not None and t["min_s"] >= s.retry_backoff_s
    s.stop()


def test_compile_fault_falls_back_direct():
    A, B = _gesv_prob(10, seed=21)
    faults.arm("compile", once=True)
    faults.on()
    s = _svc(ExecutableCache(manifest_path=None))  # cold: the site fires on a build
    with metrics.deltas() as d:
        X = s.submit("gesv", A, B).result(timeout=120)
        assert np.abs(A @ X - B).max() < 1e-8
        assert d.get("faults.injected.compile") == 1 and d.get("serve.fallbacks") == 1
    s.stop()


def test_worker_death_respawns_and_redelivers(shared_cache):
    rng = np.random.default_rng(1)
    B = rng.standard_normal((10, 2))
    mats = [rng.standard_normal((10, 10)) + 10 * np.eye(10) for _ in range(3)]
    faults.arm("worker_death", once=True)
    faults.on()
    s = _svc(shared_cache, start=False)
    with metrics.deltas() as d:
        futs = [s.submit("gesv", A, B, retries=1) for A in mats]
        s.start()
        out = [f.result(timeout=120) for f in futs]
        assert d.get("serve.worker_restarts") == 1
        assert d.get("faults.injected.worker_death") == 1
    for A, X in zip(mats, out):
        assert np.abs(A @ X - B).max() < 1e-8
    h = s.health()
    assert h["worker_restarts"] == 1 and h["worker_alive"] and h["ok"]
    s.stop()


def test_worker_death_fails_fast_without_budget(shared_cache):
    A, B = _gesv_prob(10, seed=22)
    faults.arm("worker_death", once=True)
    faults.on()
    s = _svc(shared_cache, start=False)
    fut = s.submit("gesv", A, B)
    s.start()
    with pytest.raises(SlateError, match="worker died"):
        fut.result(timeout=120)
    assert np.all(np.isfinite(s.submit("gesv", A, B).result(timeout=120)))
    assert s.health()["worker_alive"]
    s.stop()


def test_info_nonzero_poisons_exactly_one_item(shared_cache):
    rng = np.random.default_rng(2)
    B = rng.standard_normal((10, 1))
    mats = [rng.standard_normal((10, 10)) + 10 * np.eye(10) for _ in range(3)]
    faults.arm("info_nonzero", once=True, info=3)
    faults.on()
    s = _svc(shared_cache, start=False)
    with metrics.deltas() as d:
        futs = [s.submit("gesv", A, B) for A in mats]
        s.start()
        with pytest.raises(NumericalError) as ei:
            futs[0].result(timeout=120)
        assert ei.value.info == 3 and ei.value.bucket == "gesv.16x16x4.float64"
        for A, f in zip(mats[1:], futs[1:]):
            assert np.abs(A @ f.result(timeout=120) - B).max() < 1e-8
        assert d.get("serve.numerical_errors") == 1
    s.stop()


def test_result_corrupt_recovers_and_opens_breaker(shared_cache):
    A, B = _gesv_prob(10, seed=3)
    faults.arm("result_corrupt", every=1)
    faults.on()
    s = _svc(shared_cache)  # degrade_after=2
    with metrics.deltas() as d:
        for _ in range(2):
            X = s.submit("gesv", A, B).result(timeout=120)
            assert np.abs(A @ X - B).max() < 1e-8  # re-solved, never the NaN
        assert d.get("serve.corrupt_result") == 2
        assert d.get("serve.breaker_open") == 1
    assert s.health()["open_buckets"]
    s.stop()


def test_latency_fault_counts_late_miss(shared_cache):
    A, B = _gesv_prob(10, seed=4)
    s = _svc(shared_cache)
    s.submit("gesv", A, B).result(timeout=120)  # warm: dispatch is fast
    faults.arm("latency", once=True, ms=400)
    faults.on()
    with metrics.deltas() as d:
        X = s.submit("gesv", A, B, deadline=0.15).result(timeout=120)
        assert np.all(np.isfinite(X))
        assert d.get("serve.deadline_miss_late") == 1
        assert d.get("serve.deadline_miss_queued") == 0
    assert metrics.hist_summary("serve.latency.gesv.16x16x4.float64.total")["count"] >= 2
    s.stop()


def test_faults_spec_arms_and_stop_disarms(shared_cache):
    A, B = _gesv_prob(10, seed=41)
    s = _svc(shared_cache, faults_spec="execute:once", start=False)
    assert faults.is_on() and "execute" in faults.stats()
    fut = s.submit("gesv", A, B, retries=1)
    s.start()
    assert np.all(np.isfinite(fut.result(timeout=120)))
    assert faults.stats()["execute"]["fired"] == 1
    s.stop()
    assert not faults.is_on() and faults.stats() == {}


# ---------------------------------------------------------------------------
# health, tracing, histograms, the planes not ported, the device
# ---------------------------------------------------------------------------


def test_health_snapshot_shape(shared_cache):
    s = _svc(shared_cache)
    h = s.health()
    for f in ("ok", "running", "worker_alive", "worker_restarts", "queue_depth",
              "queue_limit", "inflight", "breakers", "open_buckets", "failures_60s",
              "failure_rate_60s", "uptime_s", "phase", "ready", "replicas"):
        assert f in h, f
    assert h["ok"] and h["ready"] and h["queue_limit"] == s.max_queue
    assert h["replicas"][0]["device"] == "cpu"
    s.stop()
    assert not s.health()["ok"] and not s.health()["running"]


def test_request_span_chain(shared_cache):
    spans.on()
    A, B = _gesv_prob(10, seed=23)
    s = _svc(shared_cache)
    s.submit("gesv", A, B).result(timeout=120)
    s.stop()
    by = {}
    for sp in spans.snapshot():
        by.setdefault(sp.trace, []).append(sp)
    [chain] = [v for k, v in by.items() if k is not None]
    names = {sp.name for sp in chain}
    assert {"request", "admit", "queued", "coalesce", "execute"} <= names
    root = next(sp for sp in chain if sp.name == "request")
    assert root.attrs["outcome"] == "ok" and root.attrs["bucket"] == "gesv.16x16x4.float64"
    assert all(sp.parent == root.sid for sp in chain if sp.name != "request")


def test_histograms_bin_as_the_jax_package():
    from slate_tpu.aux import metrics as jmetrics

    obs = np.random.default_rng(3).lognormal(-6, 2, 500)
    jmetrics.off()
    jmetrics.reset()
    jmetrics.on()
    try:
        with metrics.deltas() as d, jmetrics.deltas() as jd:
            for v in obs:
                metrics.observe_hist("x", float(v))
                jmetrics.observe_hist("x", float(v))
            assert d.hist("x") == jd.hist("x")
        assert metrics.hist_summary("x") == jmetrics.hist_summary("x")
        for p in (50, 95, 99):
            assert metrics.percentile("x", p) == jmetrics.percentile("x", p)
    finally:
        jmetrics.off()
        jmetrics.reset()


@pytest.mark.parametrize("kw,item", [
    (dict(tenants="gold:weight=4"), "item 7"), (dict(adaptive=True), "item 7"),
    # the admission plane (item 7b) beside the integrity plane and the
    # replica pool
    (dict(tenants="gold:weight=4", integrity="full"), "item 7"),
    (dict(adaptive=True, placement=PlacementPolicy(replicas=2, devices=["cpu"])), "item 7"),
])
def test_planes_not_ported_raise_naming_their_item(shared_cache, kw, item):
    """The configurations that raised while the admission plane was not
    ported now build it, on every lane, and serve."""
    from slate_tpu_torch.serve.admission import FairQueue

    s = _svc(shared_cache, **kw)
    try:
        adm = s._admission
        assert adm is not None
        assert adm.tenancy == ("tenants" in kw) and adm.adaptive == ("adaptive" in kw)
        assert all(isinstance(rep.q, FairQueue) for rep in s._replicas)
        A, B = _gesv_prob(10, seed=31)
        X = s.submit("gesv", A, B, tenant="gold", priority="high").result(timeout=120)
        assert _rel(X, np.linalg.solve(A, B)) < _tol(np.float64, 10)
        assert s.health()["admission"]["tenancy"] == adm.tenancy
    finally:
        s.stop()


def test_mesh_and_artifacts_raise(monkeypatch, tmp_path):
    """A mesh still raises naming item 8; the artifact store is ported
    (item 4b): the env builds one."""
    with pytest.raises(NotImplementedError, match="item 8"):
        PlacementPolicy(mesh="2x2")
    monkeypatch.setenv("SLATE_TPU_ARTIFACTS", str(tmp_path / "store"))
    assert ExecutableCache().artifacts.root == str(tmp_path / "store")
    key = bk.BucketKey("gesv", 16, 16, 4, "float64", 16, mesh="2x2")
    from slate_tpu_torch.serve.cache import _build_core

    with pytest.raises(NotImplementedError, match="item 8"):
        _build_core(key)


def test_no_cuda_and_no_device_raises(monkeypatch, shared_cache):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DistributedException):
        SolverService(cache=shared_cache)
    with pytest.raises(DistributedException):
        direct_call("gesv", np.eye(4), np.ones((4, 1)))


def test_kernel_library_builds_once_under_threads(monkeypatch):
    """The serve worker and warmup() may reach the kernel library's first
    load together: it builds (nvcc) exactly once."""
    calls = []
    sentinel = [object()]

    def fake_build(verbose=False):
        calls.append(threading.get_ident())
        time.sleep(0.05)  # hold the window open for the other threads
        return [], ""

    monkeypatch.setattr(pk, "_libs", None)
    monkeypatch.setattr(pk, "build", fake_build)
    monkeypatch.setattr(pk, "_open", lambda sos: sentinel)
    got = []
    threads = [threading.Thread(target=lambda: got.append(pk._load())) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1
    assert len(got) == 8 and all(g is sentinel for g in got)


def test_manifest_json_is_the_jax_package_text(tmp_path):
    """A manifest the port writes is byte-equal to the JAX package's for
    the same entries."""
    entries = [(bk.bucket_for("gesv", 10, 10, 1, np.float64, floor=FLOOR), 1),
               (bk.bucket_for("gels", 40, 12, 2, np.float32, floor=FLOOR).solve_sibling(), 4)]
    path = str(tmp_path / "m.json")
    c = ExecutableCache(manifest_path=path)
    for k, b in entries:
        c.ensure_manifest(k, (b,))
    from slate_tpu.serve import buckets as jbk

    jentries = [(jbk.BucketKey.from_json(k.to_json()), b) for k, b in entries]
    with open(path) as f:
        assert f.read() == jbk.manifest_dumps(jentries) + "\n"
    assert json.loads(open(path).read())["version"] == 1
