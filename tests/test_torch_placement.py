"""The port's replica placement and pool on the CPU (ROADMAP.md Queue 1
item 7a): ``select_replica`` held to the JAX package's policy on the
same loads, breaker flags and strategies; device wrapping; admission
steering around a cooling breaker; both lanes serving; ``add_replica``
warm through ``prime()`` (no cold build on traffic); ``remove_replica``
re-homing its queue with no loss; and the kernel library's first load
shared by the lanes of one device.

Services run on a CPU placement (``devices=["cpu"]``: every lane pins
the CPU, as every lane pins ``cuda:0`` on one H100) at small buckets
(floor 16, nrhs floor 4); results are held to 200 n eps relative of
``numpy.linalg.solve``."""

import threading
import time

import numpy as np
import pytest
import torch

from slate_tpu.serve.placement import PlacementPolicy as JPlacementPolicy
from slate_tpu_torch.aux import faults, metrics
from slate_tpu_torch.ops.hopper import panel_kernels as pk
from slate_tpu_torch.serve import buckets as bk
from slate_tpu_torch.serve.cache import ExecutableCache
from slate_tpu_torch.serve.placement import PlacementPolicy
from slate_tpu_torch.serve.service import LANE_REMOVED, SolverService

torch.set_num_threads(1)

FLOOR, NRHS_FLOOR = 16, 4


@pytest.fixture(autouse=True)
def _env():
    metrics.off()
    metrics.reset()
    metrics.on()
    faults.reset()
    pk.reset_launches()
    yield
    faults.reset()
    metrics.off()
    metrics.reset()
    assert all(v == 0 for v in pk.LAUNCHES.values()), pk.LAUNCHES


@pytest.fixture(scope="module")
def shared_cache():
    return ExecutableCache(manifest_path=None)


def _svc(cache, replicas=2, **kw):
    kw.setdefault("batch_max", 4)
    kw.setdefault("batch_window_s", 0.002)
    kw.setdefault("dim_floor", FLOOR)
    kw.setdefault("nrhs_floor", NRHS_FLOOR)
    kw.setdefault("placement", PlacementPolicy(replicas=replicas, devices=["cpu"]))
    return SolverService(cache=cache, **kw)


def _problem(n=12, nrhs=2, seed=0, spd=False):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n))
    A = G @ G.T + n * np.eye(n) if spd else G + n * np.eye(n)
    return A, rng.standard_normal((n, nrhs))


def _close(A, B, X):
    ref = np.linalg.solve(A, B)
    return np.abs(X - ref).max() <= 200 * A.shape[0] * np.finfo(float).eps * np.abs(ref).max()


def _key(n=12, nrhs=2):
    return bk.bucket_for("gesv", n, n, nrhs, np.float64, floor=FLOOR, nrhs_floor=NRHS_FLOOR)


# ---------------------------------------------------------------------------
# the policy against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["least_loaded", "round_robin"])
@pytest.mark.parametrize("replicas", [2, 3, 4])
def test_select_replica_matches_the_jax_package(strategy, replicas):
    """The same seeded sequence of loads and breaker / quarantine flags
    picks the same lane in both packages, call after call (the
    round-robin cursor included)."""
    rng = np.random.default_rng(replicas)
    ours = PlacementPolicy(replicas=replicas, strategy=strategy, devices=["cpu"] * replicas)
    theirs = JPlacementPolicy(replicas=replicas, strategy=strategy, devices=[None] * replicas)
    for _ in range(64):
        loads = [int(v) for v in rng.integers(0, 3, replicas)]
        flags = None if rng.random() < 0.3 else [bool(v) for v in rng.random(replicas) < 0.4]
        assert ours.select_replica(loads, flags) == theirs.select_replica(loads, flags)


def test_select_replica_skew_exclusion_and_ties():
    pol = PlacementPolicy(replicas=4, devices=["cpu"])
    assert pol.select_replica([5, 3, 0, 7]) == 2
    assert pol.select_replica([0, 4, 2, 9], [True, False, False, False]) == 2
    assert pol.select_replica([3, 1, 2, 5], [True] * 4) == 1  # all flagged: least loaded
    assert sorted({pol.select_replica([0, 0, 0, 0]) for _ in range(8)}) == [0, 1, 2, 3]
    rr = PlacementPolicy(replicas=3, strategy="round_robin", devices=["cpu"])
    assert [rr.select_replica([9, 0, 0]) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError):
        pol.select_replica([])
    with pytest.raises(ValueError):
        PlacementPolicy(strategy="typo", devices=["cpu"])


def test_devices_wrap_and_set_replicas():
    pol = PlacementPolicy(replicas=3, devices=["cpu", "meta"])
    assert [str(d) for d in pol.replica_devices()] == ["cpu", "meta", "cpu"]
    assert pol.set_replicas(5) == 5 and len(pol.replica_devices()) == 5
    assert pol.set_replicas(0) == 1
    one = PlacementPolicy(replicas=2, devices=["cpu"])
    assert one.replica_devices() == [torch.device("cpu")] * 2
    assert PlacementPolicy.from_options(replicas=3, devices=["cpu"]).replicas == 3
    assert one.mesh_for("gesv", 10 ** 6, sharded=None) == ""


def test_mesh_raises_naming_item_8():
    with pytest.raises(NotImplementedError, match="item 8"):
        PlacementPolicy(mesh="2x2", devices=["cpu"])


def test_default_pool_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert PlacementPolicy(replicas=2).replica_devices() == [torch.device("cuda", 0)] * 2


# ---------------------------------------------------------------------------
# the replica pool
# ---------------------------------------------------------------------------


def test_both_lanes_serve_with_dispatch_counts(shared_cache):
    s = _svc(shared_cache)
    try:
        probs = [_problem(seed=i, spd=i % 2 == 1) for i in range(12)]
        futs = [s.submit(("gesv", "posv")[i % 2], a, b) for i, (a, b) in enumerate(probs)]
        for (a, b), f in zip(probs, futs):
            assert _close(a, b, f.result(timeout=60))
        c = metrics.counters()
        d0, d1 = c.get("serve.replica.0.dispatched", 0), c.get("serve.replica.1.dispatched", 0)
        assert d0 > 0 and d1 > 0 and d0 + d1 == 12
        h = s.health()
        assert [r["name"] for r in h["replicas"]] == ["0", "1"]
        assert all(r["device"] == "cpu" and r["state"] == "live" for r in h["replicas"])
        assert sum(r["dispatched"] for r in h["replicas"]) == 12
    finally:
        s.stop()


def test_breaker_cooling_lane_excluded_at_admission(shared_cache):
    """Admission steers a bucket's traffic off a lane whose breaker is
    open while its cooldown runs, and selects the lane again once it
    elapses (so the half-open probe can reach it)."""
    s = _svc(shared_cache, breaker_cooldown_s=60.0, start=False)
    A, B = _problem(seed=11)
    key = _key()
    br = bk.Breaker()
    br.record_failure(time.monotonic(), 1)
    s._replicas[0].breakers[key] = br
    for _ in range(3):
        s.submit("gesv", A, B)
    assert len(s._replicas[0].q) == 0 and len(s._replicas[1].q) == 3
    h = s.health()
    assert h["replicas"][0]["breakers"][key.label] == bk.BREAKER_OPEN
    assert h["breakers"][key.label] == bk.BREAKER_OPEN  # worst state wins
    br.opened_at -= 61.0
    s.submit("gesv", A, B)
    assert len(s._replicas[0].q) == 1
    s.stop()


def test_add_replica_warms_through_prime(tmp_path):
    """A lane added to a running service on a new device is primed from
    the manifest before it takes traffic: the stream after it makes no
    cold build on any lane."""
    c = ExecutableCache(manifest_path=str(tmp_path / "m.json"))
    s = _svc(c, replicas=1, placement=PlacementPolicy(replicas=1, devices=["cpu", "cpu:1"]))
    try:
        A, B = _problem(seed=3)
        assert _close(A, B, s.submit("gesv", A, B).result(timeout=60))
        s.warmup()
        name = s.add_replica()
        assert name == "1" and s._replicas[1].device == torch.device("cpu", 1)
        c_ = metrics.counters()
        assert c_.get("scale.replicas_added") == 1 and c_.get("scale.prime_compiled", 0) == 0
        with metrics.deltas() as d:
            probs = [_problem(seed=20 + i) for i in range(8)]
            futs = [s.submit("gesv", a, b) for a, b in probs]
            for (a, b), f in zip(probs, futs):
                assert _close(a, b, f.result(timeout=60))
            assert d.get("jit.compilations") == 0
            assert d.get("serve.replica.1.dispatched") > 0
        assert metrics.counters().get("serve.device_primes", 0) >= 2  # both batch points
    finally:
        s.stop()
    with pytest.raises(RuntimeError):
        s.add_replica()


def test_remove_replica_rehomes_its_queue(shared_cache):
    """The lane leaves admission at once, its queued requests move to the
    survivor, every future resolves correctly, and its health row stays
    with the terminal state."""
    s = _svc(shared_cache, start=False)
    probs = [_problem(seed=40 + i) for i in range(8)]
    futs = [s.submit("gesv", a, b) for a, b in probs]
    assert len(s._replicas[1].q) > 0
    assert s.remove_replica() == "1"
    assert len(s._replicas) == 1 and len(s._replicas[0].q) == 8
    s.start()
    try:
        for (a, b), f in zip(probs, futs):
            assert _close(a, b, f.result(timeout=60))
        rows = {r["name"]: r for r in s.health()["replicas"]}
        assert rows["1"]["state"] == LANE_REMOVED and not rows["1"]["worker_alive"]
        c = metrics.counters()
        assert c.get("scale.requests_rehomed", 0) >= 1
        assert c.get("serve.replica.1.removed") == 1
        with pytest.raises(ValueError):
            s.remove_replica()  # the last lane
        assert s.add_replica(warm=False) == "2"  # names are never reused
        with pytest.raises(ValueError):
            s.remove_replica("7")
    finally:
        s.stop()


def test_remove_replica_drains_a_running_lane(shared_cache):
    s = _svc(shared_cache)
    try:
        faults.arm("latency", every=1, ms=20)
        faults.on()
        probs = [_problem(seed=60 + i) for i in range(6)]
        futs = [s.submit("gesv", a, b) for a, b in probs]
        s.remove_replica("0")
        faults.reset()
        for (a, b), f in zip(probs, futs):
            assert _close(a, b, f.result(timeout=60))
        assert [r["name"] for r in s.health()["replicas"] if r["state"] == "live"] == ["1"]
    finally:
        s.stop()


def test_factor_cache_follows_a_removed_lane(shared_cache):
    from slate_tpu_torch.serve.factor_cache import FactorCache

    fc = FactorCache(max_entries=4)
    s = _svc(shared_cache, factor_cache=fc)
    try:
        A, B = _problem(seed=70)
        assert _close(A, B, s.submit("gesv", A, B).result(timeout=60))
        owner = next(iter(fc._entries.values())).replica
        s.remove_replica(owner)
        survivor = s._replicas[0].name
        assert next(iter(fc._entries.values())).replica == survivor
        assert _close(A, B, s.submit("gesv", A, B).result(timeout=60))
        assert metrics.counters().get("serve.factor_cache.hit", 0) >= 1
    finally:
        s.stop()


def test_cross_lane_hit_while_the_owner_cools_down(shared_cache):
    """A hit whose owning lane's solve bucket is cooling down is served by
    the other lane from the same cached factor (counted), not spilled."""
    from slate_tpu_torch.serve.factor_cache import FactorCache

    fc = FactorCache(max_entries=4)
    s = _svc(shared_cache, factor_cache=fc, breaker_cooldown_s=60.0)
    try:
        A, B = _problem(seed=80)
        assert _close(A, B, s.submit("gesv", A, B).result(timeout=60))
        entry = next(iter(fc._entries.values()))
        own = next(r for r in s._replicas if r.name == entry.replica)
        br = s._breaker(own, entry.solve_key.solve_sibling())
        br.record_failure(time.monotonic(), 1)
        X = s.submit("gesv", A, B).result(timeout=60)
        assert _close(A, B, X)
        assert metrics.counters().get("serve.factor_cache.cross_lane_hit") == 1
    finally:
        s.stop()


def test_library_first_load_shared_by_lanes(monkeypatch):
    """Lanes on one device reach the kernel library's first load
    together: it builds once and every lane gets the same handles."""
    calls = []

    def fake_build(verbose=False):
        calls.append(threading.get_ident())
        time.sleep(0.05)
        return [], ""

    monkeypatch.setattr(pk, "_libs", None)
    monkeypatch.setattr(pk, "_libs_digest", None)
    monkeypatch.setattr(pk, "LOADED_FROM", None)
    monkeypatch.setattr(pk, "build", fake_build)
    monkeypatch.setattr(pk, "_open", lambda sos: ["lib"])
    got = []
    ts = [threading.Thread(target=lambda: got.append(pk._load())) for _ in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(calls) == 1 and len(got) == 6 and all(g is got[0] for g in got)
    assert pk.LOADED_FROM == pk.BUILD_DIR and pk._libs_digest == pk.library_digest()


def test_launch_counts_survive_concurrent_lanes():
    """Lanes sharing the card count kernel launches from several threads
    (ctypes drops the interpreter lock in the call): no count is lost."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pk.reset_launches()

        def lane():
            for _ in range(2000):
                pk._count("gemm_sub")
                pk._count("trsm_lower", 3)

        ts = [threading.Thread(target=lane) for _ in range(12)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        assert pk.LAUNCHES["gemm_sub"] == 24000 and pk.LAUNCHES["trsm_lower"] == 72000
    finally:
        sys.setswitchinterval(old)
        pk.reset_launches()
