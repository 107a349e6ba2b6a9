"""Port parity: slate_tpu_torch.fabric (the device factor arena and the
streaming gels sessions) and its serve-tier hooks, against the JAX
package's fabric on the CPU.

Every case of the JAX package's tests/test_fabric.py runs on the port at
its sizes (m <= 48, n <= 16), with operands from a seeded numpy
generator, plus the parity cases: the armed port and the armed JAX
service count the same ``serve.arena.*`` events for the same request
stream; a session's X agrees with the JAX session's and with numpy's
``lstsq`` within 1e-10 (f64: absolute; c128: relative to max|X|); the
armed and unarmed port services give byte-identical X on one stream; and
``tools/factor_report.py`` reads the port's dump.  On the CPU the
arena's "device" is the CPU, so an upload is ``.to`` of a tensor already
there: the counters and the byte ledger are what is compared.  A
module-scoped ExecutableCache lets each gels bucket build once."""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from slate_tpu.aux import faults as jfaults
from slate_tpu.aux import metrics as jmetrics
from slate_tpu.fabric import arena as jarena
from slate_tpu.fabric import session as jsession
from slate_tpu_torch.aux import faults, metrics
from slate_tpu_torch.enums import Option
from slate_tpu_torch.exceptions import DimensionError, InvalidInput, NumericalError
from slate_tpu_torch.fabric import (
    ARENA_ENV,
    FactorArena,
    FactorSession,
    arena_from_options,
    parse_arena_spec,
)
from slate_tpu_torch.fabric.session import _update_r
from slate_tpu_torch.serve import buckets as bk
from slate_tpu_torch.serve.cache import ExecutableCache
from slate_tpu_torch.serve.factor_cache import (
    FactorCache,
    FactorEntry,
    gels_factor_pack,
    matrix_fingerprint,
    residual_ok,
    solve_from_factor,
)
from slate_tpu_torch.serve.placement import PlacementPolicy
from slate_tpu_torch.serve.service import SolverService

torch.set_num_threads(1)

FLOOR = 16
NRHS_FLOOR = 4
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def metrics_on():
    for m in (metrics, jmetrics):
        m.off()
        m.reset()
        m.on()
    yield
    for m in (metrics, jmetrics):
        m.off()
        m.reset()
    faults.reset()
    jfaults.reset()


@pytest.fixture(scope="module")
def shared_cache():
    return ExecutableCache(manifest_path=None)


def _svc(shared_cache, replicas=1, **kw):
    kw.setdefault("batch_max", 4)
    kw.setdefault("batch_window_s", 0.002)
    kw.setdefault("dim_floor", FLOOR)
    kw.setdefault("nrhs_floor", NRHS_FLOOR)
    kw.setdefault("placement", PlacementPolicy(replicas=replicas, devices=["cpu"]))
    return SolverService(cache=shared_cache, **kw)


def _tall(m, n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        A = A + 1j * rng.standard_normal((m, n))
    return A.astype(dtype)


def _lstsq(A, B):
    return np.linalg.lstsq(A, B, rcond=None)[0]


def _session(A, **kw):
    return FactorSession(None, A, device="cpu", **kw)


def _arena_counters(mod):
    return {k: v for k, v in mod.counters().items() if k.startswith("serve.arena.")}


# ---------------------------------------------------------------------------
# arena: activation grammar
# ---------------------------------------------------------------------------


def test_parse_arena_spec():
    for off in ("", "0", "off", "false", "no", "OFF"):
        assert parse_arena_spec(off) is None
    for on in ("1", "on", "true", "yes", "ON"):
        assert parse_arena_spec(on) == {}
    assert parse_arena_spec("bytes=4096") == {"max_bytes": 4096}
    assert parse_arena_spec("bytes=1e6") == {"max_bytes": 1000000}
    for bad in ("entries=4", "bytes"):
        with pytest.raises(ValueError) as e:
            parse_arena_spec(bad)
        with pytest.raises(ValueError) as je:
            jarena.parse_arena_spec(bad)
        assert str(e.value) == str(je.value)
    for spec in ("", "on", "bytes=4096", " bytes = 2e3 ,"):
        assert parse_arena_spec(spec) == jarena.parse_arena_spec(spec)
    assert ARENA_ENV == jarena.ARENA_ENV


def test_arena_from_env_and_options(monkeypatch):
    monkeypatch.setenv(ARENA_ENV, "bytes=2048")
    ar = arena_from_options()
    assert ar is not None and ar.max_bytes == 2048
    # an explicitly-off env wins over an armed option spec
    monkeypatch.setenv(ARENA_ENV, "off")
    assert arena_from_options({Option.ServeFactorArena: "1"}) is None
    # env unset: the option spec decides
    monkeypatch.delenv(ARENA_ENV)
    assert arena_from_options() is None  # default spec "" = off
    ar = arena_from_options({Option.ServeFactorArena: "bytes=512"})
    assert ar is not None and ar.max_bytes == 512


def test_service_default_has_no_arena(shared_cache, monkeypatch):
    """Off by default: a factor-cache service without the env / option
    carries arena=None (the one-branch hot path), an arena is never
    built without a factor cache to feed it, and the env arms it."""
    monkeypatch.delenv(ARENA_ENV, raising=False)
    svc = _svc(shared_cache, factor_cache=FactorCache(max_entries=4), start=False)
    assert svc.arena is None and svc.health()["arena"] is None
    svc.stop()
    svc = _svc(shared_cache, factor_cache=False, factor_arena=FactorArena(), start=False)
    assert svc.arena is None  # no cache -> nothing to make resident
    svc.stop()
    monkeypatch.setenv(ARENA_ENV, "bytes=4096")
    svc = _svc(shared_cache, factor_cache=FactorCache(max_entries=4), start=False)
    assert svc.arena is not None and svc.arena.max_bytes == 4096
    svc.stop()
    svc = _svc(shared_cache, factor_cache=FactorCache(max_entries=4), factor_arena=False,
               start=False)
    assert svc.arena is None  # False wins over the env
    svc.stop()


# ---------------------------------------------------------------------------
# arena: residency semantics
# ---------------------------------------------------------------------------


def test_arena_hit_counts_upload_avoided():
    ar = FactorArena(max_bytes=1 << 20)
    F = torch.ones((8, 8), dtype=torch.float64)
    buf = ar.put("fp-a", "lane0", F)
    assert buf is not None and len(ar) == 1
    with metrics.deltas() as d:
        got = ar.get("fp-a", "lane0")
        assert got is buf
        assert d.get("serve.arena.hit") == 1
        assert d.get("serve.arena.upload_avoided_bytes") == 8 * 8 * 8
        assert d.get("serve.arena.lane.lane0.hit") == 1
    with metrics.deltas() as d:
        assert ar.get("fp-b", "lane0", any_lane=False) is None
        assert d.get("serve.arena.miss") == 1
    # a numpy factor is taken too, counted by its numpy bytes
    with metrics.deltas() as d:
        ar.put("fp-c", "lane0", np.ones((4, 4)), device=CPU)
        assert d.get("serve.arena.upload_bytes") == np.ones((4, 4)).nbytes


def test_arena_lru_budget_eviction():
    F = np.ones((8, 8))  # 512 B each
    ar = FactorArena(max_bytes=2 * F.nbytes)
    ar.put("a", "l", F)
    ar.put("b", "l", F)
    ar.get("a", "l")  # refresh a: b becomes LRU
    with metrics.deltas() as d:
        ar.put("c", "l", F)
        assert d.get("serve.arena.evict") == 1
    assert ar.get("b", "l", any_lane=False) is None  # evicted
    assert ar.get("a", "l") is not None
    assert ar.get("c", "l") is not None
    assert ar.stats()["bytes"] <= ar.max_bytes


def test_arena_oversize_uncacheable():
    F = np.ones((16, 16))
    ar = FactorArena(max_bytes=F.nbytes - 1)
    buf = ar.put("big", "l", F)
    assert buf is not None  # the caller still dispatches this upload
    assert len(ar) == 0  # but it never became resident
    assert ar.get("big", "l", any_lane=False) is None


def test_arena_cross_replica_share():
    ar = FactorArena(max_bytes=1 << 20)
    F = torch.arange(16.0, dtype=torch.float64).reshape(4, 4)
    ar.put("fp", "lane0", F)
    with metrics.deltas() as d:
        buf = ar.get("fp", "lane1", device=CPU)
        assert buf is not None
        assert d.get("serve.arena.cross_replica") == 1
    assert buf.tolist() == F.tolist()
    # the copy installed on the requesting lane: the next get is a hit
    with metrics.deltas() as d:
        assert ar.get("fp", "lane1") is not None
        assert d.get("serve.arena.hit") == 1
    assert ar.stats()["lanes"]["lane1"]["bytes"] == F.numel() * 8


def test_arena_drop_spill_drop_lane():
    F = np.ones((4, 4))
    ar = FactorArena(max_bytes=1 << 20)
    for i in range(4):
        ar.put(f"fp{i}", "l0", F)
    ar.put("fp0", "l1", F)
    assert ar.drop("fp0") == 2  # both lanes
    assert ar.get("fp0", "l0", any_lane=False) is None
    with metrics.deltas() as d:
        # 3 resident: keep floor(3 * 0.5) = 1, spill the 2 LRU
        n = ar.spill("l0", keep_frac=0.5)
        assert n == 2 and d.get("serve.arena.spill") == 2
    assert ar.drop_lane("l0") == 1  # the MRU survivor
    assert ar.stats()["lanes"].get("l0", {}).get("entries", 0) == 0
    assert ar.pressure("l1", CPU) == 0  # no memory stats on the CPU
    assert ar.clear() == 0 and len(ar) == 0


# ---------------------------------------------------------------------------
# gels factor pack (factor-cache layer)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_gels_pack_solve_parity(dtype):
    m, n, nrhs = 20, 12, 2
    key = bk.bucket_for("gels", m, n, nrhs, dtype, floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    A = _tall(m, n, seed=1, dtype=dtype)
    pack = gels_factor_pack(A, key, device="cpu")
    assert tuple(pack.shape) == bk.solve_factor_shape(key)
    entry = FactorEntry(fp="x", routine="gels", key=key, factor=pack, perm=None, n=n)
    B = _tall(m, nrhs, seed=2, dtype=dtype)
    X = solve_from_factor(entry, B)
    assert X.shape == (n, nrhs)
    assert np.abs(X - _lstsq(A, B)).max() < 1e-9
    assert residual_ok(A, B, X, routine="gels")
    # a finite-but-wrong X fails the gels (normal-equations) fence
    bad = np.array(X)
    bad[0, 0] = bad[0, 0] * 2 + 1
    assert not residual_ok(A, B, bad, routine="gels")


def test_factor_cache_update_rejects_gels():
    key = bk.bucket_for("gels", 20, 12, 2, np.float64, floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    A = _tall(20, 12, seed=3)
    fc = FactorCache(max_entries=4)
    entry = FactorEntry(fp="g1", routine="gels", key=key,
                        factor=gels_factor_pack(A, key, device="cpu"), perm=None, n=12)
    assert fc.put(entry)
    with pytest.raises(ValueError, match=r"serve\.session\(routine='gels'\)"):
        fc.update("g1", A, np.ones(12))


# ---------------------------------------------------------------------------
# session: streamed update vs refactor parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("k", [1, 5, 17])
def test_update_r_matches_refactor(dtype, k):
    """The O(k n^2) Householder fold keeps R^H R = A^H A to sqrt(eps),
    for rank-1 and rank-k appends, real and complex, and agrees with the
    JAX package's fold of the same R and rows within 100 n eps."""
    m, n = 40, 13
    A = _tall(m, n, seed=4, dtype=dtype)
    R0 = np.array(np.linalg.qr(A, mode="r")[:n])
    C = _tall(k, n, seed=5, dtype=dtype)
    R = torch.from_numpy(R0.copy())
    _update_r(R, torch.from_numpy(C.copy()))
    R = R.numpy()
    A2 = np.vstack([A, C])
    G, G2 = R.conj().T @ R, A2.conj().T @ A2
    eps = np.finfo(np.dtype(dtype)).eps
    assert np.abs(G - G2).max() <= np.sqrt(eps) * np.abs(G2).max()
    assert np.abs(np.tril(R, -1)).max() == 0.0  # still upper triangular
    Rj = R0.copy()
    jsession._update_r(Rj, C.copy())
    assert np.abs(R - Rj).max() <= 100 * n * eps * np.abs(Rj).max()


def test_update_r_skips_zero_rows_exactly():
    """A zero appended row leaves R bitwise unchanged (tau = 0 through
    ``torch.where``), a zero pivot takes beta = -||x||, as the JAX
    package's branches do."""
    R0 = np.triu(_tall(6, 6, seed=40)) + 6 * np.eye(6)
    R = torch.from_numpy(R0.copy())
    _update_r(R, torch.zeros((2, 6), dtype=torch.float64))
    assert np.array_equal(R.numpy(), R0)
    R0[2, 2] = 0.0
    C = _tall(1, 6, seed=41)
    R, Rj = torch.from_numpy(R0.copy()), R0.copy()
    _update_r(R, torch.from_numpy(C.copy()))
    jsession._update_r(Rj, C.copy())
    np.testing.assert_allclose(R.numpy(), Rj, rtol=0, atol=1e-13)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("k", [1, 4])
def test_session_update_vs_refactor_parity(dtype, k):
    m, n = 30, 10
    A = _tall(m, n, seed=6, dtype=dtype)
    s = _session(A)
    C = _tall(k, n, seed=7, dtype=dtype)
    with metrics.deltas() as d:
        s.append(C)
        assert d.get("fabric.session.factor") == 1
        assert d.get("fabric.session.update") == 1
        assert d.get("fabric.session.update_rows") == k
    A2 = np.vstack([A, C])
    B = _tall(m + k, 3, seed=8, dtype=dtype)
    with metrics.deltas() as d:
        X = s.solve(B)
        assert d.get("fabric.session.solve") == 1
        assert d.get("fabric.session.fence_fail") == 0
    ref = _lstsq(A2, B)
    tol = np.sqrt(np.finfo(np.dtype(dtype)).eps)
    assert np.abs(X - ref).max() <= tol * max(np.abs(ref).max(), 1.0)
    assert not s.pristine and s.shape == (m + k, n)
    assert s.stats() == {"rows": m + k, "n": n, "pristine": False, "solves": 1,
                         "updates": 1, "refactors": 0}


def test_session_many_appends_stay_fenced():
    """Every streamed solve is fenced (fabric.session.solve counts them
    all; zero fence failures on a well-conditioned stream)."""
    rng = np.random.default_rng(9)
    A = _tall(25, 8, seed=9)
    s = _session(A)
    A_cur = A
    with metrics.deltas() as d:
        for _ in range(6):
            C = rng.standard_normal((2, 8))
            s.append(C)
            A_cur = np.vstack([A_cur, C])
            B = rng.standard_normal((A_cur.shape[0], 2))
            assert np.abs(s.solve(B) - _lstsq(A_cur, B)).max() < 1e-9
        assert d.get("fabric.session.solve") == 6
        assert d.get("fabric.session.fence_fail") == 0
        assert d.get("fabric.session.refactor") == 0
        assert d.get("fabric.session.update_rows") == 12


def test_session_fence_failure_pays_counted_refactor():
    """A corrupted maintained factor never surfaces as a wrong X: the
    fence trips, a counted refactor repairs R, and X is right; a system
    whose fresh factor fails the fence too raises NumericalError."""
    A = _tall(30, 10, seed=10)
    s = _session(A)
    s.append(_tall(3, 10, seed=11))
    with s._lock:  # bit-rot the maintained triangle behind the session's back
        s._R = s._R.clone()
        s._R[0, 0] = s._R[0, 0] * 2 + 1
    B = _tall(33, 2, seed=12)
    with metrics.deltas() as d:
        X = s.solve(B)
        assert d.get("fabric.session.fence_fail") == 1
        assert d.get("fabric.session.refactor") == 1
    assert np.abs(X - _lstsq(np.asarray(s._A), B)).max() < 1e-9
    # a fence that no factor can pass: the second failure raises
    s._csne_locked = lambda B: np.full((10, B.shape[1]), 1e3)
    with metrics.deltas() as d:
        with pytest.raises(NumericalError):
            s.solve(B)
        assert d.get("fabric.session.fence_fail") == 2
        assert d.get("fabric.session.refactor") == 1


def test_session_update_fault_site_recovers():
    """The session_update chaos site perturbs R after a fold; the next
    solve's fence catches it and the refactor path delivers a correct X
    (its SiteSpec is the JAX package's)."""
    assert repr(faults.SITE_REGISTRY["session_update"]) == repr(
        jfaults.SITE_REGISTRY["session_update"])
    A = _tall(30, 10, seed=13)
    s = _session(A)
    s.append(_tall(2, 10, seed=14))  # builds R (un-faulted)
    faults.arm("session_update", once=True)
    faults.on()
    try:
        s.append(_tall(2, 10, seed=15))  # the fold this site poisons
        B = _tall(34, 2, seed=16)
        assert faults.stats()["session_update"]["fired"] == 1
        with metrics.deltas() as d:
            X = s.solve(B)
            assert d.get("fabric.session.refactor") == 1
        assert np.abs(X - _lstsq(np.asarray(s._A), B)).max() < 1e-9
    finally:
        faults.reset()


def test_session_breakdown_on_rank_collapse_refactors():
    """An update that collapses a diagonal (a rank-deficient fold) is a
    breakdown: append itself repairs it by a counted refactor."""
    A = np.eye(12, 8) + 0.01 * _tall(12, 8, seed=17)
    s = _session(A)
    s.append(_tall(1, 8, seed=18))
    with s._lock:  # simulate a collapsed pivot from a degenerate fold
        s._R = s._R.clone()
        s._R[3, 3] = 0.0
    with metrics.deltas() as d:
        # an all-zero row leaves every column untouched, so the collapsed
        # pivot survives the fold and trips the check inside append
        s.append(np.zeros((1, 8)))
        assert d.get("fabric.session.refactor") == 1
    B = _tall(14, 2, seed=20)
    assert np.abs(s.solve(B) - _lstsq(np.asarray(s._A), B)).max() < 1e-9


def test_session_validation():
    with pytest.raises(InvalidInput):
        _session(_tall(20, 10), routine="gesv")
    with pytest.raises(DimensionError):
        _session(_tall(8, 10))  # wide
    with pytest.raises(InvalidInput):
        _session(np.full((10, 4), np.nan))
    s = _session(_tall(20, 10, seed=21))
    with pytest.raises(DimensionError):
        s.append(np.ones((2, 7)))  # wrong column count
    with pytest.raises(InvalidInput):
        s.append(np.full((1, 10), np.inf))
    s.append(np.ones((1, 10)))
    with pytest.raises(DimensionError):
        s.solve(np.ones((20, 2)))  # stale m after append
    assert s.solve(np.ones(21)).shape == (10,)  # a vector B gives a vector X


# ---------------------------------------------------------------------------
# serving-tier integration
# ---------------------------------------------------------------------------


def test_warmed_session_stream_compile_free(shared_cache):
    """Pristine session solves ride the warmed gels solve bucket: hits
    only, no cold build, no factor re-upload (the arena holds the pack)."""
    fc = FactorCache(max_entries=8)
    svc = _svc(shared_cache, factor_cache=fc, factor_arena=FactorArena())
    try:
        rng = np.random.default_rng(22)
        A = _tall(20, 12, seed=22)
        svc.submit("gels", A, rng.standard_normal((20, 2))).result(timeout=300)
        svc.warmup()  # the miss registered the solve bucket
        s = FactorSession(svc, A)
        assert s.device == CPU  # the service's first lane
        with metrics.deltas() as d:
            for _ in range(5):
                B = rng.standard_normal((20, 2))
                assert np.abs(s.solve(B) - _lstsq(A, B)).max() < 1e-9
            assert d.get("serve.factor_cache.hit") == 5
            assert d.get("jit.compilations") == 0
            assert d.get("serve.arena.upload_avoided_bytes") > 0
            # one upload on the first hit, resident after it
            assert d.get("serve.arena.upload_bytes") > 0 and d.get("serve.arena.hit") == 4
        assert s.pristine
    finally:
        svc.stop()


def test_arena_upload_avoided_accounting(shared_cache):
    """upload_avoided_bytes = the pack's bytes x device hits, and the
    armed cache's entry records its home device."""
    fc = FactorCache(max_entries=8)
    svc = _svc(shared_cache, factor_cache=fc, factor_arena=FactorArena())
    try:
        rng = np.random.default_rng(23)
        A = _tall(20, 12, seed=23)
        svc.submit("gels", A, rng.standard_normal((20, 2))).result(timeout=300)
        svc.warmup()
        fp = matrix_fingerprint(A, "gels", schedule=svc.schedule)
        entry = fc.get(fp)
        assert entry.home == CPU
        nbytes = entry.factor.numel() * entry.factor.element_size()
        with metrics.deltas() as d:
            for _ in range(4):
                svc.submit("gels", A, rng.standard_normal((20, 2))).result(timeout=300)
            hits = int(d.get("serve.arena.hit"))
            assert hits >= 3
            assert d.get("serve.arena.upload_avoided_bytes") == hits * nbytes
    finally:
        svc.stop()


def test_session_survives_arena_eviction_pressure(shared_cache):
    """Eviction under byte pressure costs only a re-upload: alternating
    same-bucket sessions whose packs cannot co-reside keep solving
    correctly while serve.arena.evict counts the churn."""
    fc = FactorCache(max_entries=8)
    key = bk.bucket_for("gels", 20, 12, 2, np.float64, floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    pack_bytes = int(np.prod(bk.solve_factor_shape(key))) * 8
    svc = _svc(shared_cache, factor_cache=fc, factor_arena=FactorArena(max_bytes=pack_bytes))
    try:
        rng = np.random.default_rng(24)
        As = [_tall(20, 12, seed=30 + i) for i in range(2)]
        sessions = [FactorSession(svc, A) for A in As]
        with metrics.deltas() as d:
            for _ in range(3):
                for A, s in zip(As, sessions):
                    B = rng.standard_normal((20, 2))
                    assert np.abs(s.solve(B) - _lstsq(A, B)).max() < 1e-9
            assert d.get("serve.arena.evict") >= 1
            assert d.get("serve.factor_cache.miss") == 2  # never a refactor
    finally:
        svc.stop()


def test_cross_lane_hit_on_cooling_breaker(shared_cache):
    """A hit whose owning lane's solve-bucket breaker is cooling re-routes
    to the other healthy lane and still reuses the cached factor through
    that lane's solve bucket (counted cross_lane_hit, not a spill); the
    armed arena serves it from the owner's residency (cross_replica)."""
    fc = FactorCache(max_entries=8)
    svc = _svc(shared_cache, replicas=2, factor_cache=fc, factor_arena=FactorArena())
    try:
        rng = np.random.default_rng(25)
        n = 12
        A = rng.standard_normal((n, n)) + n * np.eye(n)
        B = rng.standard_normal((n, 2))
        svc.submit("gesv", A, B).result(timeout=300)
        svc.warmup()
        svc.submit("gesv", A, B).result(timeout=300)  # resident on the owner
        fp = matrix_fingerprint(A, "gesv", schedule=svc.schedule)
        entry = fc.get(fp)
        own = next(r for r in svc._replicas if r.name == entry.replica)
        br = svc._breaker(own, entry.solve_key)
        br.state = bk.BREAKER_OPEN
        br.opened_at = time.monotonic()
        with metrics.deltas() as d:
            X = svc.submit("gesv", A, B).result(timeout=300)
            assert d.get("serve.factor_cache.cross_lane_hit") == 1
            assert d.get("serve.factor_cache.spill") == 0
            assert d.get("serve.factor_cache.hit") == 1
            assert d.get("serve.arena.cross_replica") == 1
        assert np.abs(X - np.linalg.solve(A, B)).max() < 1e-9
        br.state = bk.BREAKER_CLOSED
        other = next(r for r in svc._replicas if r is not own)
        assert svc.remove_replica(other.name) == other.name
        assert other.lane not in svc.health()["arena"]["lanes"]  # drop_lane
    finally:
        svc.stop()


def test_invalidation_drops_arena_residency(shared_cache):
    """Cache invalidation and arena residency stay coherent: the service
    drops the fingerprint's device buffers with the host entry (a stale
    hit too), and ``serve.invalidate`` does both."""
    from slate_tpu_torch import serve

    fc = FactorCache(max_entries=8)
    ar = FactorArena()
    svc = _svc(shared_cache, factor_cache=fc, factor_arena=ar)
    try:
        rng = np.random.default_rng(26)
        A = _tall(20, 12, seed=26)
        svc.submit("gels", A, rng.standard_normal((20, 2))).result(timeout=300)
        svc.warmup()
        svc.submit("gels", A, rng.standard_normal((20, 2))).result(timeout=300)
        assert len(ar) == 1
        fp = matrix_fingerprint(A, "gels", schedule=svc.schedule)
        fc.invalidate(fp)
        ar.drop(fp)  # what serve.invalidate() does
        assert len(ar) == 0
        assert svc.health()["arena"]["entries"] == 0
        # a stale factor caught by the hit's residual fence leaves no
        # resident copy behind (on the CPU the resident buffer is the host
        # entry's tensor, so the rot reaches both)
        svc.submit("gels", A, rng.standard_normal((20, 2))).result(timeout=300)
        svc.submit("gels", A, rng.standard_normal((20, 2))).result(timeout=300)
        assert len(ar) == 1
        fc.get(fp).factor[0, 0] += 1.0  # bit rot
        with metrics.deltas() as d:
            B = rng.standard_normal((20, 2))
            X = svc.submit("gels", A, B).result(timeout=300)
            assert d.get("serve.factor_cache.stale") == 1 and d.get("serve.arena.drop") == 1
        assert np.abs(X - _lstsq(A, B)).max() < 1e-9
        assert len(ar) == 0
    finally:
        svc.stop()
    old = serve.api._service
    try:
        serve.api._service = svc2 = _svc(shared_cache, factor_cache=FactorCache(max_entries=8),
                                         factor_arena=FactorArena())
        assert serve.get_arena() is svc2.arena
        A = _tall(20, 12, seed=27)
        for _ in range(2):
            svc2.submit("gels", A, np.ones((20, 2))).result(timeout=300)
        assert len(svc2.arena) == 1
        assert serve.invalidate(serve.factor_fingerprint("gels", A)) is True
        assert len(svc2.arena) == 0
        sess = serve.session(A)
        assert sess.pristine and sess._svc is svc2
    finally:
        svc2.stop()
        serve.api._service = old


# ---------------------------------------------------------------------------
# parity with the JAX package's fabric
# ---------------------------------------------------------------------------


def _stream(svc, routine_A, rng):
    """The request stream both services serve: a gels miss, warmup,
    hits, an invalidation, a re-miss and its hits, a spill, a hit."""
    A = routine_A
    out = [svc.submit("gels", A, rng.standard_normal((A.shape[0], 2))).result(timeout=300)]
    svc.warmup()
    for _ in range(4):
        out.append(svc.submit("gels", A, rng.standard_normal((A.shape[0], 2))).result(
            timeout=300))
    fp = next(iter(svc.factor_cache.fingerprints()))
    svc.factor_cache.invalidate(fp)
    svc.arena.drop(fp)
    for _ in range(3):
        out.append(svc.submit("gels", A, rng.standard_normal((A.shape[0], 2))).result(
            timeout=300))
    svc.arena.spill(svc._replicas[0].lane, keep_frac=0.0)
    out.append(svc.submit("gels", A, rng.standard_normal((A.shape[0], 2))).result(
        timeout=300))
    return np.stack(out)


def test_arena_counters_equal_jax(shared_cache):
    """The same request stream through the armed port and the armed JAX
    service counts the same serve.arena.* events, global and per lane,
    and delivers X within 1e-10 of the JAX service's."""
    from slate_tpu.serve.cache import ExecutableCache as JCache
    from slate_tpu.serve.factor_cache import FactorCache as JFactorCache
    from slate_tpu.serve.service import SolverService as JService

    A = _tall(40, 12, seed=50)
    svc = _svc(shared_cache, factor_cache=FactorCache(max_entries=8),
               factor_arena=FactorArena())
    try:
        X = _stream(svc, A, np.random.default_rng(51))
    finally:
        svc.stop()
    jsvc = JService(cache=JCache(manifest_path=None), batch_max=4, batch_window_s=0.002,
                    dim_floor=FLOOR, nrhs_floor=NRHS_FLOOR,
                    factor_cache=JFactorCache(max_entries=8),
                    factor_arena=jarena.FactorArena())
    try:
        Xj = _stream(jsvc, A, np.random.default_rng(51))
    finally:
        jsvc.stop()
    got, ref = _arena_counters(metrics), _arena_counters(jmetrics)
    # 3 + 1 resident hits; an upload after each of the 3 arena misses
    assert got == ref and ref["serve.arena.hit"] == 4, (got, ref)
    assert ref["serve.arena.miss"] == 3 and ref["serve.arena.spill"] == 1
    assert np.abs(X - Xj).max() < 1e-10


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_session_x_matches_jax_and_lstsq(shared_cache, dtype):
    """A session stream (pristine solves through the armed service, two
    appends, streamed solves) gives X within 1e-10 of the JAX session's
    and of numpy's lstsq (absolute in f64, relative to max|X| in c128)."""
    from slate_tpu.serve.cache import ExecutableCache as JCache
    from slate_tpu.serve.factor_cache import FactorCache as JFactorCache
    from slate_tpu.serve.service import SolverService as JService

    m, n = 48, 16
    A = _tall(m, n, seed=60, dtype=dtype)
    Cs = [_tall(5, n, seed=61, dtype=dtype), _tall(3, n, seed=62, dtype=dtype)]
    Bs = [_tall(m, 2, seed=63, dtype=dtype), _tall(m + 5, 2, seed=64, dtype=dtype),
          _tall(m + 8, 2, seed=65, dtype=dtype)]

    def run(s):
        out = [s.solve(Bs[0])]
        for C, B in zip(Cs, Bs[1:]):
            s.append(C)
            out.append(s.solve(B))
        return out

    svc = _svc(shared_cache, factor_cache=FactorCache(max_entries=8),
               factor_arena=FactorArena())
    try:
        got = run(FactorSession(svc, A))
    finally:
        svc.stop()
    jsvc = JService(cache=JCache(manifest_path=None), batch_max=4, batch_window_s=0.002,
                    dim_floor=FLOOR, nrhs_floor=NRHS_FLOOR,
                    factor_cache=JFactorCache(max_entries=8),
                    factor_arena=jarena.FactorArena())
    try:
        ref = run(jsession.FactorSession(jsvc, A))
    finally:
        jsvc.stop()
    Acur = A
    for i, (x, xj) in enumerate(zip(got, ref)):
        if i:
            Acur = np.vstack([Acur, Cs[i - 1]])
        scale = np.abs(xj).max() if np.dtype(dtype).kind == "c" else 1.0
        assert np.abs(x - xj).max() <= 1e-10 * scale
        assert np.abs(x - _lstsq(Acur, Bs[i])).max() <= 1e-10 * scale


def test_armed_and_unarmed_byte_identical(shared_cache):
    """The armed and the unarmed port services give byte-identical X on
    one stream (a miss, warmed hits, a session append and a streamed
    solve), and the unarmed one moves no serve.arena.* counter."""
    A = _tall(40, 12, seed=70)
    C = _tall(5, 12, seed=71)

    def leg(arena):
        rng = np.random.default_rng(72)
        fc = FactorCache(max_entries=8)
        svc = _svc(shared_cache, factor_cache=fc, factor_arena=arena)
        try:
            X = [svc.submit("gels", A, rng.standard_normal((40, 2))).result(timeout=300)]
            svc.warmup()
            s = FactorSession(svc, A)
            X += [s.solve(rng.standard_normal((40, 2))) for _ in range(6)]
            s.append(C)
            X.append(s.solve(rng.standard_normal((45, 2))))
            entry = fc.get(fc.fingerprints()[0])
            return np.stack(X[:-1]), X[-1], entry.home
        finally:
            svc.stop()

    Xu, xu, home_u = leg(False)
    assert _arena_counters(metrics) == {}
    Xa, xa, home_a = leg(FactorArena())
    assert home_u is None and home_a == CPU
    assert Xu.dtype == Xa.dtype and Xu.tobytes() == Xa.tobytes()
    assert xu.tobytes() == xa.tobytes()
    assert metrics.counters()["serve.arena.hit"] == 5


def test_factor_report_reads_the_port_dump(shared_cache, tmp_path):
    """tools/factor_report.py reads the armed port's metrics dump
    unchanged: exit 0, and the arena section (not the legacy marker)."""
    svc = _svc(shared_cache, factor_cache=FactorCache(max_entries=8),
               factor_arena=FactorArena())
    try:
        _stream(svc, _tall(40, 12, seed=80), np.random.default_rng(81))
    finally:
        svc.stop()
    path = metrics.dump(str(tmp_path / "fabric.jsonl"))
    r = subprocess.run([sys.executable, str(REPO / "tools" / "factor_report.py"), path],
                       capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "arena (device-resident factors)" in r.stdout and "legacy" not in r.stdout
