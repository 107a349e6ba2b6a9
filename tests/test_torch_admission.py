"""The admission plane of slate_tpu_torch against the JAX package's, on
the CPU: the tenant grammar and its errors, the token bucket, the
weighted-fair queue, the AIMD window and the overload controller are
driven with the same inputs and the same fake clock in both packages
and must decide the same, step for step; the health snapshots must be
equal.  Then both services (CPU placement for the port) refuse the same
requests: a rate-limited tenant's third back-to-back call, low before
normal under forced overload, the tenant_flood burst.  Last, the port's
two-leg fairness stream at small n: the static service misses the
victim's p99 budget, the adaptive one holds it and sheds the abuser."""

import dataclasses
import random
import time
from collections import deque

import numpy as np
import pytest
import torch

from slate_tpu.aux import faults as jfaults
from slate_tpu.aux import metrics as jmetrics
from slate_tpu.exceptions import SlateError as JSlateError
from slate_tpu.serve import admission as jadm
from slate_tpu.serve import cache as jcache
from slate_tpu.serve import service as jservice
from slate_tpu_torch import serve
from slate_tpu_torch.aux import faults, metrics
from slate_tpu_torch.exceptions import SlateError
from slate_tpu_torch.serve import admission as adm
from slate_tpu_torch.serve import buckets as bk
from slate_tpu_torch.serve.service import Rejected, Shed

torch.set_num_threads(1)

FLOOR, NRHS_FLOOR = 16, 4


@pytest.fixture(autouse=True)
def _env():
    for m in (metrics, jmetrics):
        m.off()
        m.reset()
        m.on()
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()
    for m in (metrics, jmetrics):
        m.off()
        m.reset()


def _gesv_prob(n, seed=0, nrhs=2):
    r = np.random.default_rng(seed)
    return r.standard_normal((n, n)) + n * np.eye(n), r.standard_normal((n, nrhs))


def _port_svc(**kw):
    kw.setdefault("cache", serve.ExecutableCache(manifest_path=None))
    kw.setdefault("batch_max", 4)
    kw.setdefault("dim_floor", FLOOR)
    kw.setdefault("nrhs_floor", NRHS_FLOOR)
    kw.setdefault("placement", serve.PlacementPolicy(devices=["cpu"]))
    return serve.SolverService(**kw)


def _jax_svc(**kw):
    kw.setdefault("cache", jcache.ExecutableCache(manifest_path=None))
    kw.setdefault("batch_max", 4)
    kw.setdefault("dim_floor", FLOOR)
    kw.setdefault("nrhs_floor", NRHS_FLOOR)
    return jservice.SolverService(**kw)


# ---------------------------------------------------------------------------
# the controllers, step for step
# ---------------------------------------------------------------------------

SPECS = ("gold:weight=4;free:weight=1,rate=20,share=0.25",
         "default:weight=2,rate=5;vip:weight=8,rate=3,burst=7",
         "a; b:share=1; c:rate=0.5", "")
BAD_SPECS = ("t:wieght=2", ":weight=2", "t:weight", "t:weight=0", "t:share=1.5",
             "t:burst=10", "t:rate=-1", "t:weight=x")


@pytest.mark.parametrize("spec", SPECS)
def test_parse_tenants_equal(spec):
    got, ref = adm.parse_tenants(spec), jadm.parse_tenants(spec)
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.items()}
    assert {k: v.capacity for k, v in got.items()} == {k: v.capacity for k, v in ref.items()}


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_tenants_errors_equal(spec):
    with pytest.raises(Exception) as ej:
        jadm.parse_tenants(spec)
    with pytest.raises(type(ej.value)) as ep:
        adm.parse_tenants(spec)
    assert str(ep.value) == str(ej.value)


def test_token_bucket_take_sequences_equal():
    rng = random.Random(5)
    t, times = 0.0, []
    for _ in range(300):
        t += rng.choice((0.0, 0.0, 0.01, 0.05, 0.3)) - (0.02 if rng.random() < 0.05 else 0.0)
        times.append(t)
    for rate, cap in ((10.0, 4), (2.0, 2), (0.5, 1)):
        a, b = adm.TokenBucket(rate, cap, now=0.0), jadm.TokenBucket(rate, cap, now=0.0)
        assert [a.take(x) for x in times] == [b.take(x) for x in times]
        assert a.remaining(t + 1) == b.remaining(t + 1)


class _R:
    """Request stub: the fields FairQueue schedules on."""

    def __init__(self, tenant, t_submit, not_before=0.0):
        self.tenant, self.t_submit, self.not_before = tenant, t_submit, not_before


def test_fairqueue_pop_order_equal():
    """A seeded 3-tenant interleaving of arrivals, retry re-enqueues at
    the head, backoff-ineligible requests and pops: the same requests in
    the same order from both queues."""
    spec = "a:weight=3;b:weight=1;c:weight=2"
    qp = adm.AdmissionControl(tenants=adm.parse_tenants(spec)).new_queue()
    qj = jadm.AdmissionControl(tenants=jadm.parse_tenants(spec)).new_queue()
    rng = random.Random(11)
    popped_p, popped_j, now, seq = [], [], 0.0, 0
    for _ in range(400):
        now += 0.01
        op = rng.random()
        if op < 0.55:
            seq += 1
            nb = now + rng.choice((0.0, 0.0, 0.0, 0.05, 0.2))
            r = (rng.choice("abc"), seq, nb)
            left = rng.random() < 0.1
            for q in (qp, qj):
                (q.appendleft if left else q.append)(_R(*r))
        else:
            a, b = qp.pop_eligible(now), qj.pop_eligible(now)
            popped_p.append(None if a is None else (a.tenant, a.t_submit))
            popped_j.append(None if b is None else (b.tenant, b.t_submit))
            assert qp._vnow == qj._vnow and qp.depths() == qj.depths()
    assert popped_p == popped_j
    assert sum(x is not None for x in popped_p) > 100
    assert [(r.tenant, r.t_submit) for r in qp] == [(r.tenant, r.t_submit) for r in qj]


def test_adaptive_window_trajectories_equal():
    rng = random.Random(3)
    for ceiling, every in ((0.01, 4), (0.002, 8), (0.05, 1)):
        wp, wj = adm.AdaptiveWindow(ceiling, decide_every=every), \
            jadm.AdaptiveWindow(ceiling, decide_every=every)
        for _ in range(500):
            budget = rng.choice((0.0, 0.25, 1.0))
            total = rng.uniform(0.0, 0.6)
            assert wp.observe(total, budget) == wj.observe(total, budget)
            assert (wp.window_s, wp.widens, wp.shrinks) == (wj.window_s, wj.widens, wj.shrinks)


def test_overload_levels_equal():
    rng = random.Random(9)
    cp, cj = adm.OverloadController(), jadm.OverloadController()
    now, levels = 0.0, set()
    for _ in range(600):
        now += rng.choice((0.001, 0.01, 0.1, 0.4))
        if rng.random() < 0.7:
            burn = rng.choice((0.1, 0.6, 0.95, 1.2, 2.5, 5.0))
            assert cp.observe(burn, now) == cj.observe(burn, now)
        else:
            assert cp.tick(now) == cj.tick(now)
        assert (cp.level, cp.ewma, cp.window_factor()) == (cj.level, cj.ewma, cj.window_factor())
        assert [cp.sheds(p) for p in range(3)] == [cj.sheds(p) for p in range(3)]
        levels.add(cp.level)
    assert levels == {0, 1, 2}
    for lvl in range(3):
        assert adm.OverloadController.shed_names(lvl) == jadm.OverloadController.shed_names(lvl)


def test_admission_health_and_snapshot_equal():
    """The same quota takes, tenant events and finished requests on a
    fake clock: equal decisions, ``tenants_health``, ``snapshot`` and
    capped metric families."""
    rng = random.Random(21)
    ops, t = [], 0.0
    for _ in range(400):
        t += rng.choice((0.0, 0.01, 0.1))
        who = rng.choice(("gold", "free", "anon", "x"))
        op = rng.random()
        if op < 0.3:
            ops.append(("take", t, who))
        elif op < 0.5:
            ops.append(("event", t, who, rng.choice(adm._EVENTS)))
        else:
            ops.append(("finish", t, who, rng.choice(("gesv.16x16x4.float64",
                                                      "posv.32x32x4.float64")),
                        rng.randrange(3), rng.uniform(0, 0.5), rng.choice((None, 0.1, 0.3))))
    spec = "gold:weight=4;free:rate=5,burst=2,share=0.5;default:weight=2"
    clock = [0.0]
    out = []
    for m in (adm, jadm):
        clock[0] = 0.0
        p = m.AdmissionControl(tenants=m.parse_tenants(spec), adaptive=True, budget_s=0.2,
                               ceiling_s=0.004, clock=lambda: clock[0])
        decisions = []
        for o in ops:
            clock[0] = o[1]
            if o[0] == "take":
                decisions.append(p.quota_take(o[2], o[1]))
            elif o[0] == "event":
                p.tenant_event(o[2], o[3])
            else:
                p.tick(o[1])
                p.observe_finish(o[3], o[2], o[4], o[5], o[6], o[1])
                decisions.append((p.overload.level, p.window_for(o[3])))
        out.append((decisions, p.tenants_health({"gold": 3, "free": 1}, now=clock[0]),
                    p.snapshot()))
    assert out[0] == out[1]
    assert out[0][2]["overload_level"] in (0, 1, 2) and out[0][2]["windows"]
    assert {k: v for k, v in metrics.counters().items() if k.startswith("serve.")} == \
        {k: v for k, v in jmetrics.counters().items() if k.startswith("serve.")}


# ---------------------------------------------------------------------------
# the services, both packages on the CPU
# ---------------------------------------------------------------------------


def _third_call(svc, A, B):
    """Three back-to-back submits: two admitted (their max |X|), the
    third refused (its error's type, tenant and priority)."""
    futs, got = [], []
    for _ in range(3):
        try:
            futs.append(svc.submit("gesv", A, B, tenant="free"))
        except (SlateError, JSlateError) as e:
            got.append((type(e).__name__, e.tenant, e.priority))
    return [float(np.abs(f.result(timeout=300)).max()) for f in futs] + got


def test_rate_limited_tenant_third_call_rejected_in_both():
    A, B = _gesv_prob(12, seed=3)
    out = []
    for make in (_port_svc, _jax_svc):
        svc = make(tenants="free:rate=2,burst=2")
        try:
            out.append(_third_call(svc, A, B))
        finally:
            svc.stop()
    assert out[0][2] == out[1][2] == ("Rejected", "free", "normal")
    np.testing.assert_allclose(out[0][:2], out[1][:2], rtol=1e-12)
    for m in (metrics, jmetrics):
        c = m.counters()
        assert c["serve.rejected_quota"] == 1 and c["serve.tenant.free.rejected"] == 1
        assert c["serve.tenant.free.admitted"] == 2


def _shed_order(svc, A, B, now):
    for _ in range(10):
        svc._admission.overload.observe(1.0, now=now)
    snap = svc.health()["admission"]
    out = []
    for p in ("low", "normal", "high"):
        try:
            svc.submit("gesv", A, B, tenant="t", priority=p).result(timeout=300)
            out.append((p, "ok"))
        except (SlateError, JSlateError) as e:
            out.append((p, type(e).__name__, e.tenant, e.priority))
    return out, snap


def test_forced_overload_sheds_low_before_normal_in_both():
    A, B = _gesv_prob(12, seed=4)
    out = []
    for make in (_port_svc, _jax_svc):
        svc = make(tenants="default:weight=1", latency_budget_s=10.0)
        try:
            out.append(_shed_order(svc, A, B, time.monotonic()))
        finally:
            svc.stop()
    (got, hp), (ref, hj) = out
    assert got == ref == [("low", "Shed", "t", "low"), ("normal", "ok"), ("high", "ok")]
    assert hp == hj and hp["overload_level"] == 1 and hp["shedding"] == ["low"]
    assert metrics.counters()["serve.shed"] == jmetrics.counters()["serve.shed"] == 1


def test_tenant_flood_counters_equal():
    A, B = _gesv_prob(12, seed=5)
    keys = ("faults.injected.tenant_flood", "serve.shed", "serve.rejected",
            "serve.rejected_quota", "serve.rejected_share", "serve.tenant.flood.admitted",
            "serve.tenant.flood.rejected", "serve.tenant.real.admitted")
    out = []
    for make, f in ((_port_svc, faults), (_jax_svc, jfaults)):
        svc = make(tenants="flood:rate=1,burst=2,share=0.2", start=False)
        try:
            f.configure("tenant_flood:once,burst=10")
            f.on()
            fut = svc.submit("gesv", A, B, tenant="real")
            f.reset()
            svc.start()
            X = fut.result(timeout=300)
            assert np.abs(A @ X - B).max() < 1e-9
        finally:
            svc.stop()
    for m in (metrics, jmetrics):
        out.append({k: m.counters().get(k, 0) for k in keys})
    assert out[0] == out[1]
    assert out[0]["faults.injected.tenant_flood"] == 1
    assert out[0]["serve.tenant.flood.rejected"] >= 8


def test_plane_off_service_keeps_deques_and_emits_nothing():
    A, B = _gesv_prob(12, seed=6)
    svc = _port_svc()
    try:
        assert svc._admission is None
        assert all(isinstance(rep.q, deque) for rep in svc._replicas)
        X1 = svc.submit("gesv", A, B).result(timeout=300)
        X2 = svc.submit("gesv", A, B, tenant="anyone", priority="low").result(timeout=300)
        assert X1.tobytes() == X2.tobytes()
        h = svc.health()
        assert h["tenants"] is None and h["admission"] is None
        assert h["devices"] is None and h["cost"] is None and h["trace_ring"] is None
        assert not [k for k in metrics.counters() if k.startswith(
            ("serve.tenant", "serve.adaptive", "serve.shed", "serve.overload",
             "serve.rejected_quota", "serve.rejected_share"))]
        with pytest.raises(ValueError):
            svc.submit("gesv", A, B, priority="urgent")
    finally:
        svc.stop()


def _fairness_leg(adaptive: bool, budget: float):
    """The JAX package's two-leg stream (run_tests.py's adaptive gate),
    on the port: 48 abuser requests, then 8 from the victim; 30 ms
    injected into every dispatch after warmup."""
    kw = dict(batch_window_s=0.01)
    if adaptive:
        kw.update(tenants="good:weight=4;abuser:rate=10,burst=4,share=0.25", adaptive=True,
                  latency_budget_s=budget)
    svc = _port_svc(**kw)
    kg = bk.bucket_for("gesv", 24, 24, 2, np.float64, floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    ka = bk.bucket_for("gesv", 12, 12, 2, np.float64, floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    for k in (kg, ka):
        svc.cache.ensure_manifest(k, (1, 4))
    svc.warmup()
    faults.configure("latency:every=1,ms=30")
    faults.on()
    A_a, B_a = _gesv_prob(12, seed=1)
    futs, refused = [], {"Shed": 0, "Rejected": 0}

    def abuse(**kw):
        try:
            futs.append(svc.submit("gesv", A_a, B_a, tenant="abuser", priority="low", **kw))
        except (Shed, Rejected) as e:
            refused[type(e).__name__] += 1

    try:
        for _ in range(48):
            abuse()
        for i in range(8):
            A, B = _gesv_prob(24, seed=100 + i)
            futs.append(svc.submit("gesv", A, B, tenant="good", priority="high", deadline=10.0))
        if adaptive:
            time.sleep(0.4)
            for _ in range(8):
                abuse(deadline=0.02)
            end = time.monotonic() + 10.0
            while refused["Shed"] == 0 and time.monotonic() < end:
                time.sleep(0.05)
                abuse(deadline=0.02)
        resolved = 0
        for f in futs:
            try:
                assert np.all(np.isfinite(f.result(timeout=300)))
            except SlateError:
                pass
            resolved += 1
        assert resolved == len(futs)
        h = svc.health()
    finally:
        faults.reset()
        svc.stop()
    return metrics.percentile(f"serve.latency.{kg.label}.total", 99), \
        metrics.percentile("serve.latency.tenant.good.total", 99), refused, h


def test_fairness_stream_static_misses_adaptive_holds():
    budget = 0.25
    p99_static, _, refused, h = _fairness_leg(False, budget)
    assert p99_static > budget and refused == {"Shed": 0, "Rejected": 0}
    assert h["tenants"] is None
    metrics.reset()
    _, p99_good, refused, h = _fairness_leg(True, budget)
    assert p99_good is not None and p99_good <= budget, p99_good
    assert refused["Shed"] > 0 and refused["Rejected"] > 0
    assert h["tenants"]["abuser"]["shed"] == refused["Shed"]
    assert h["admission"]["overload_level"] >= 1
