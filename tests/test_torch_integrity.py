"""The port's integrity plane on the CPU (ROADMAP.md Queue 1 item 7a),
held against the JAX package on the same numpy operands and seeds: the
policy grammar, the seeded sampling gate, the quarantine score's state
sequence, the host certificates, the ABFT checksum relations (the same
corrupted factor entries and solutions flagged), the overhead accounting,
and one deterministic cross-package stream through two-lane services
with the same ``serve.integrity.*`` totals.  Then the service behaviour
of tests/test_integrity.py on the port: certification with hedged
re-execution, sdc_factor on the factor path, quarantine and its probe,
straggler hedging, the hedge group, and a plane that is off touching
nothing.

Services run on a CPU placement at small buckets (floor 16, nrhs floor
4).  Solutions are held to 200 n eps relative of ``numpy.linalg.solve``
(and of the JAX package's for the cross-package stream)."""

import time
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.aux import faults as jfaults
from slate_tpu.aux import metrics as jmetrics
from slate_tpu.integrity import abft as jabft
from slate_tpu.integrity import policy as jpol
from slate_tpu.serve import buckets as jbk
from slate_tpu.serve.cache import ExecutableCache as JExecutableCache
from slate_tpu.serve.placement import PlacementPolicy as JPlacementPolicy
from slate_tpu.serve.service import SolverService as JSolverService
from slate_tpu_torch.aux import faults, metrics
from slate_tpu_torch.exceptions import NumericalError, SlateError
from slate_tpu_torch.integrity import abft
from slate_tpu_torch.integrity import policy as pol
from slate_tpu_torch.ops.hopper import panel_kernels as pk
from slate_tpu_torch.serve import buckets as bk
from slate_tpu_torch.serve.cache import ExecutableCache
from slate_tpu_torch.serve.factor_cache import FactorCache, factor_only
from slate_tpu_torch.serve.placement import PlacementPolicy
from slate_tpu_torch.serve.service import SolverService, _HedgeGroup, _Request, _resolve, \
    _resolve_exc

torch.set_num_threads(1)

FLOOR, NRHS_FLOOR = 16, 4
_POLICY_FIELDS = ("mode", "sample_p", "abft", "hedge_factor", "hedge_min_age_s",
                  "quarantine_cooldown_s", "quarantine_threshold", "quarantine_alpha",
                  "cert_retry_max")


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


def _svc(cache, replicas=1, **kw):
    cfg = dict(cache=cache, batch_max=4, batch_window_s=0.002, dim_floor=FLOOR,
               nrhs_floor=NRHS_FLOOR, degrade_after=2, retry_backoff_s=0.002,
               retry_backoff_cap_s=0.05, breaker_cooldown_s=0.05,
               placement=PlacementPolicy(replicas=replicas, devices=["cpu"]))
    cfg.update(kw)
    return SolverService(**cfg)


def _problem(n=12, nrhs=2, seed=0, spd=False):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n))
    A = G @ G.T + n * np.eye(n) if spd else G + n * np.eye(n)
    return A, rng.standard_normal((n, nrhs))


def _close(X, ref):
    return np.abs(X - ref).max() <= 200 * X.shape[0] * np.finfo(float).eps * np.abs(ref).max()


# ---------------------------------------------------------------------------
# the policy, the sampling gate and the score against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "full", "full,abft", "sample=0.25", "sample=0.5,abft,hedge=2.5,cooldown=1.5",
    "full,abft,hedge=0", "full,threshold=0.9,alpha=0.25,retries=3,seed=4"])
def test_parse_spec_matches_the_jax_package(spec):
    ours, theirs = pol.parse_spec(spec), jpol.parse_spec(spec)
    assert {f: getattr(ours, f) for f in _POLICY_FIELDS} == \
        {f: getattr(theirs, f) for f in _POLICY_FIELDS}
    assert ours.describe() == theirs.describe()


def test_parse_spec_off_and_bad_specs_as_the_jax_package(monkeypatch):
    for off in ("", "off", "0", "no"):
        assert pol.parse_spec(off) is None and jpol.parse_spec(off) is None
    for bad in ("bogus", "sample", "sample=2.0", "full,nope=1", "full,threshold=0"):
        with pytest.raises(ValueError):
            jpol.parse_spec(bad)
        with pytest.raises(ValueError):
            pol.parse_spec(bad)
    monkeypatch.setenv(pol.INTEGRITY_ENV, "full,abft")
    assert pol.from_options(None).abft and pol.from_options(False) is None
    mine = pol.IntegrityPolicy(mode="full")
    assert pol.from_options(mine) is mine
    monkeypatch.setenv(pol.INTEGRITY_ENV, "off")
    assert pol.from_options(None) is None


@pytest.mark.parametrize("seed", [0, 7])
def test_sampling_draws_match_the_jax_package(seed):
    ours = pol.parse_spec(f"sample=0.25,seed={seed}")
    theirs = jpol.parse_spec(f"sample=0.25,seed={seed}")
    draws = [ours.should_check() for _ in range(200)]
    assert draws == [theirs.should_check() for _ in range(200)]
    assert 20 < sum(draws) < 80


def test_integrity_score_states_match_the_jax_package():
    """A seeded sequence of verdicts at seeded times: the same transitions,
    states, exclusion windows and snapshots in both packages."""
    rng = np.random.default_rng(3)
    ours = pol.IntegrityScore(alpha=0.5, threshold=0.6, cooldown_s=1.0)
    theirs = jpol.IntegrityScore(alpha=0.5, threshold=0.6, cooldown_s=1.0)
    t, events = 100.0, []
    for _ in range(300):
        t += float(rng.exponential(0.3))
        ok = bool(rng.random() < 0.6)
        ev = ours.observe(ok, t)
        assert ev == theirs.observe(ok, t)
        events.append(ev)
        assert ours.excluded(t + 0.5) == theirs.excluded(t + 0.5)
        assert ours.suspect() == theirs.suspect()
        assert ours.snapshot(t) == theirs.snapshot(t)
    assert "quarantined" in events and "recovered" in events


# ---------------------------------------------------------------------------
# certificates and checksum relations against the JAX package's
# ---------------------------------------------------------------------------


def _corruptions(X, rng, k=6):
    out = [X.copy()]
    for _ in range(k):
        Xw = X.copy()
        i = tuple(int(rng.integers(0, s)) for s in X.shape)
        Xw[i] = Xw[i] * 2 + 1
        out.append(Xw)
    Xn = X.copy()
    Xn.reshape(-1)[0] = np.nan
    return out + [Xn]


@pytest.mark.parametrize("routine", ["gesv", "posv"])
def test_certificates_give_equal_verdicts(routine):
    rng = np.random.default_rng(9)
    for n, nrhs in ((12, 2), (20, 1), (33, 4)):
        A, B = _problem(n, nrhs, seed=n, spd=routine == "posv")
        Aj = A.copy()
        if routine == "posv":
            Aj[np.triu_indices(n, 1)] = 1e3  # posv reads the lower triangle only
        X = np.linalg.solve(A, B)
        for Xc in _corruptions(X, rng):
            assert abft.checksum_certificate(A, B, Xc) == jabft.checksum_certificate(A, B, Xc)
            got = pol.residual_certificate(routine, Aj, Xc, B)
            assert got == jpol.residual_certificate(routine, Aj, Xc, B)
        assert pol.residual_certificate(routine, Aj, X, B)
        assert pol.residual_certificate("gels", A, X * 0, B)  # no residual contract


def test_encode_and_accounting_match_the_jax_package():
    rng = np.random.default_rng(3)
    A, B = rng.standard_normal((7, 7)), rng.standard_normal((7, 3))
    np.testing.assert_array_equal(abft.encode(A), jabft.encode(A))
    np.testing.assert_array_equal(abft.encode_rhs(B), jabft.encode_rhs(B))
    np.testing.assert_array_equal(abft.encode_rhs(B[:, 0]), jabft.encode_rhs(B[:, 0]))
    assert abs(np.linalg.det(abft.encode(A))) < 1e-8  # the bordered form is singular
    for n, nrhs in ((12, 2), (2048, 8), (4096, 16)):
        assert abft.abft_flops(n, nrhs) == jabft.abft_flops(n, nrhs)
        for routine in ("gesv", "posv"):
            k = bk.bucket_for(routine, n, n, nrhs, np.float64, tag=abft.ABFT_TAG)
            jk = jbk.bucket_for(routine, n, n, nrhs, np.float64, tag=jabft.ABFT_TAG)
            assert abft.overhead_ratio(k) == jabft.overhead_ratio(jk)
            if n >= 2048:
                assert 0 < abft.overhead_ratio(k) <= 0.15
    assert (abft.ABFT_TAG, abft.ABFT_BAD) == (jabft.ABFT_TAG, jabft.ABFT_BAD)


def _jcheck(fn, *args):
    return bool(fn(*[jnp.asarray(a) for a in args]))


def test_checksum_relations_flag_the_same_corruptions():
    """gesv_check / posv_check on the port's own factors: the same
    verdict as the JAX package's checks for the clean pipeline and for
    every corrupted factor entry (L, U, the pivots' image) and solution."""
    rng = np.random.default_rng(2)
    A, B = _problem(n=10, seed=2)
    F, perm = factor_only("gesv", A, device="cpu")
    F, perm = F.numpy(), perm.numpy()
    X = np.linalg.solve(A, B)

    def both(Fx, Xx):
        ours = bool(abft.gesv_check(*map(torch.from_numpy, (A, B, Fx, perm, Xx))))
        assert ours == _jcheck(jabft.gesv_check, A, B, Fx, perm, Xx)
        return ours

    assert not both(F, X)
    flagged = 0
    for _ in range(12):
        i, j = (int(v) for v in rng.integers(0, 10, 2))
        Fw = F.copy()
        Fw[i, j] = Fw[i, j] * 2 + 1
        flagged += both(Fw, X)
    assert flagged >= 11
    for Xw in _corruptions(X, rng, k=4)[1:-1]:
        assert both(F, Xw)

    S, Bs = _problem(n=10, seed=3, spd=True)
    Sj = S.copy()
    Sj[np.triu_indices(10, 1)] = 1e3  # junk above the diagonal never flags
    L = factor_only("posv", S, device="cpu")[0].numpy()
    Xs = np.linalg.solve(S, Bs)

    def both_p(Lx, Xx):
        ours = bool(abft.posv_check(*map(torch.from_numpy, (Sj, Bs, Lx, Xx))))
        assert ours == _jcheck(jabft.posv_check, Sj, Bs, Lx, Xx)
        return ours

    assert not both_p(L, Xs)
    for _ in range(8):
        i = int(rng.integers(0, 10))
        j = int(rng.integers(0, i + 1))
        Lw = L.copy()
        Lw[i, j] = Lw[i, j] * 2 + 1
        assert both_p(Lw, Xs)
    for Xw in _corruptions(Xs, rng, k=3)[1:-1]:
        assert both_p(L, Xw)


def test_abft_core_clean_and_flags_via_info():
    core = abft.build_core("gesv", 16, "auto")
    A, B = _problem(n=12, seed=4)
    Ap = torch.from_numpy(bk.pad_square(A, 16))
    Bp = torch.from_numpy(bk.pad_rhs(B, 16, 4))
    Xg, info = core(Ap, Bp)
    assert int(info) == 0 and _close(Xg.numpy()[:12, :2], np.linalg.solve(A, B))
    Xg, info = core(torch.zeros(16, 16, dtype=torch.float64), Bp)
    assert int(info) > 0  # driver info wins over the flag
    pcore = abft.build_core("posv", 16, "pallas")
    S, Bs = _problem(n=12, seed=5, spd=True)
    Xg, info = pcore(torch.from_numpy(bk.pad_square(S, 16)),
                     torch.from_numpy(bk.pad_rhs(Bs, 16, 4)))
    assert int(info) == 0 and _close(Xg.numpy()[:12, :2], np.linalg.solve(S, Bs))
    assert abft._fold(torch.tensor(0), torch.tensor(True)) == abft.ABFT_BAD
    with pytest.raises(ValueError):
        abft.build_core("gels", 16, "auto")


# ---------------------------------------------------------------------------
# the cross-package stream
# ---------------------------------------------------------------------------


def _idle(svc):
    """Wait until every lane is empty and idle, so each submit sees the
    same loads in both packages."""
    for _ in range(2000):
        with svc._cond:
            if all(not r.q and not r.inflight for r in svc._replicas):
                return
        time.sleep(0.001)
    raise AssertionError("lanes never went idle")


def _stream(svc, probs):
    out = []
    for routine, A, B in probs:
        _idle(svc)
        out.append(svc.submit(routine, A, B).result(timeout=300))
    _idle(svc)
    return out


_TOTALS = ("serve.integrity.checked", "serve.integrity.fail", "serve.integrity.recovered",
           "serve.integrity.abandoned", "serve.integrity.quarantined",
           "serve.integrity.unquarantined", "serve.hedge.sent", "serve.hedge.won")


def test_cross_package_stream_equal_integrity_totals():
    """batch_max=1, integrity "full,abft,hedge=0" (hedging is timed, so
    off), two lanes, sdc_solve on every third dispatch in both packages:
    the same serve.integrity.* / serve.hedge.* totals (they do not depend
    on which lane took a request), every X within 200 n eps relative of
    the JAX package's."""
    probs = []
    for i in range(10):
        routine = ("gesv", "posv")[i % 2]
        A, B = _problem(n=(12, 14)[i % 3 == 0], nrhs=2, seed=300 + i, spd=routine == "posv")
        probs.append((routine, A, B))
    spec = "full,abft,hedge=0"
    jmetrics.off()
    jmetrics.reset()
    jmetrics.on()
    jfaults.reset()
    jsvc = JSolverService(cache=JExecutableCache(manifest_path=None), batch_max=1,
                          batch_window_s=0.0, dim_floor=FLOOR, nrhs_floor=NRHS_FLOOR,
                          integrity=spec, factor_cache=False,
                          placement=JPlacementPolicy(replicas=2,
                                                     devices=[jax.devices()[0]] * 2))
    try:
        jfaults.arm("sdc_solve", every=3)
        jfaults.on()
        jX = _stream(jsvc, probs)
        jc = jmetrics.counters()
    finally:
        jfaults.reset()
        jsvc.stop()
        jmetrics.off()
        jmetrics.reset()
    svc = _svc(ExecutableCache(manifest_path=None), replicas=2, batch_max=1,
               batch_window_s=0.0, integrity=spec, factor_cache=False)
    try:
        faults.arm("sdc_solve", every=3)
        faults.on()
        X = _stream(svc, probs)
    finally:
        faults.reset()
        svc.stop()
    c = metrics.counters()
    totals = {k: c.get(k, 0) for k in _TOTALS}
    assert totals == {k: jc.get(k, 0) for k in _TOTALS}
    assert totals["serve.integrity.fail"] >= 3 and totals["serve.integrity.recovered"] >= 3
    assert c.get("faults.injected.sdc_solve") == jc.get("faults.injected.sdc_solve")
    for (routine, A, B), x, jx in zip(probs, X, jX):
        assert _close(x, np.asarray(jx)) and _close(x, np.linalg.solve(A, B))


# ---------------------------------------------------------------------------
# the service (tests/test_integrity.py on the port)
# ---------------------------------------------------------------------------


def test_abft_buckets_route_and_serve_correctly(shared_cache):
    svc = _svc(shared_cache, integrity=pol.IntegrityPolicy(mode="full", abft=True,
                                                           hedge_factor=0.0))
    try:
        for routine, seed in (("gesv", 20), ("posv", 21)):
            A, B = _problem(seed=seed, spd=routine == "posv")
            assert _close(svc.submit(routine, A, B).result(timeout=60), np.linalg.solve(A, B))
        c = metrics.counters()
        assert c.get("serve.integrity.checked", 0) >= 2 and c.get("serve.integrity.fail", 0) == 0
        assert any(abft.ABFT_TAG in k.label for k, _b in svc.cache.entries())
        h = svc.health()["integrity"]
        assert h["policy"] == "full,abft" and h["abft"] and h["quarantined"] == []
    finally:
        svc.stop()


def test_abft_excluded_when_factor_cache_on():
    svc = _svc(ExecutableCache(manifest_path=None), integrity="full,abft,hedge=0", factor_cache=FactorCache())
    try:
        A, B = _problem(seed=22)
        assert _close(svc.submit("gesv", A, B).result(timeout=60), np.linalg.solve(A, B))
        assert metrics.counters().get("serve.factor_cache.miss", 0) >= 1
        assert not any(abft.ABFT_TAG in k.label for k, _b in svc.cache.entries())
    finally:
        svc.stop()


def test_certificate_failure_hedges_and_recovers(shared_cache):
    svc = _svc(shared_cache, replicas=2, integrity=pol.IntegrityPolicy(
        mode="full", hedge_factor=0.0, quarantine_cooldown_s=5.0))
    try:
        A, B = _problem(seed=23)
        svc.submit("gesv", A, B).result(timeout=60)
        faults.arm("sdc_solve", once=True)
        faults.on()
        probs = [_problem(seed=30 + i) for i in range(6)]
        futs = [svc.submit("gesv", a, b) for a, b in probs]
        for (a, b), f in zip(probs, futs):
            assert _close(f.result(timeout=60), np.linalg.solve(a, b))
        c = metrics.counters()
        assert c.get("faults.injected.sdc_solve") == 1
        assert c.get("serve.integrity.fail", 0) >= 1
        assert c.get("serve.integrity.recovered", 0) >= 1
        assert c.get("serve.hedge.sent", 0) >= 1 and c.get("serve.hedge.won", 0) >= 1
    finally:
        svc.stop()


def test_single_lane_reexecutes_direct(shared_cache):
    svc = _svc(shared_cache, integrity="full,hedge=0")
    try:
        faults.arm("sdc_solve", once=True)
        faults.on()
        A, B = _problem(seed=24)
        assert _close(svc.submit("gesv", A, B).result(timeout=60), np.linalg.solve(A, B))
        c = metrics.counters()
        assert c.get("serve.integrity.fail") == 1 and c.get("serve.integrity.recovered") == 1
        assert c.get("serve.fallbacks") == 1 and c.get("serve.hedge.sent", 0) == 0
    finally:
        svc.stop()


def test_abandoned_past_the_retry_budget(shared_cache):
    """Every execution corrupted: the request is refused with a typed
    error (never a wrong X) after the last-resort direct solve."""
    svc = _svc(shared_cache, integrity="full,hedge=0,retries=1")
    try:
        faults.arm("sdc_solve", every=1)
        faults.on()
        A, B = _problem(seed=25)
        with pytest.raises(NumericalError, match="certification"):
            svc.submit("gesv", A, B).result(timeout=60)
        assert metrics.counters().get("serve.integrity.abandoned") == 1
    finally:
        svc.stop()


def test_sdc_factor_caught_on_factor_path(shared_cache):
    svc = _svc(shared_cache, integrity="full,hedge=0", factor_cache=FactorCache())
    try:
        A, B = _problem(seed=40)
        faults.arm("sdc_factor", once=True)
        faults.on()
        assert _close(svc.submit("gesv", A, B).result(timeout=60), np.linalg.solve(A, B))
        c = metrics.counters()
        assert c.get("faults.injected.sdc_factor") == 1
        assert c.get("serve.integrity.fail", 0) + c.get("serve.factor_cache.stale", 0) >= 1
        assert faults.SITE_REGISTRY["sdc_factor"].recovery == \
            jfaults.SITE_REGISTRY["sdc_factor"].recovery
    finally:
        svc.stop()


def test_quarantine_engages_and_probes_back(shared_cache):
    svc = _svc(shared_cache, replicas=2, batch_max=1, integrity=pol.IntegrityPolicy(
        mode="full", hedge_factor=0.0, quarantine_cooldown_s=0.15, cert_retry_max=1))
    try:
        A, B = _problem(seed=50)
        svc.submit("gesv", A, B).result(timeout=60)
        faults.arm("sdc_solve", every=1)
        faults.on()
        for f in [svc.submit("gesv", *_problem(seed=60 + i)) for i in range(8)]:
            try:
                f.result(timeout=60)  # typed errors allowed; hangs not
            except SlateError:
                pass
        assert metrics.counters().get("serve.integrity.quarantined", 0) >= 1
        assert svc.health()["integrity"]["quarantined"]
        faults.reset()
        time.sleep(0.2)  # the cooldown elapses; the next delivery is the probe
        for i in range(4):
            a, b = _problem(seed=80 + i)
            assert _close(svc.submit("gesv", a, b).result(timeout=60), np.linalg.solve(a, b))
        assert not svc.health()["integrity"]["quarantined"]
        assert metrics.counters().get("serve.integrity.unquarantined", 0) >= 1
        assert any(k.startswith("serve.replica.") and k.endswith(".quarantined")
                   for k in metrics.counters())
    finally:
        svc.stop()


def test_quarantined_lane_excluded_at_admission(shared_cache):
    svc = _svc(shared_cache, replicas=2, start=False,
               integrity=pol.IntegrityPolicy(mode="full", quarantine_cooldown_s=10.0))
    try:
        r0 = svc._replicas[0]
        now = time.monotonic()
        r0.score.observe(False, now)
        assert r0.score.observe(False, now) == "quarantined"
        key = bk.bucket_for("gesv", 12, 12, 2, np.float64, floor=FLOOR, nrhs_floor=NRHS_FLOOR)
        with svc._cond:
            assert all(svc._pick_replica_locked(key) is svc._replicas[1] for _ in range(6))
        r0.score.quarantined_at = now - 11.0
        with svc._cond:
            assert "0" in {svc._pick_replica_locked(key).name for _ in range(6)}
    finally:
        svc.stop()


def test_posv_certified_with_junk_upper_triangle(shared_cache):
    svc = _svc(shared_cache, integrity="full,hedge=0")
    try:
        A, B = _problem(seed=200, spd=True)
        Aj = A.copy()
        Aj[np.triu_indices(12, 1)] = 1e3
        assert _close(svc.submit("posv", Aj, B).result(timeout=60), np.linalg.solve(A, B))
        c = metrics.counters()
        assert c.get("serve.integrity.checked", 0) >= 1
        assert c.get("serve.integrity.fail", 0) == 0 and c.get("serve.integrity.abandoned", 0) == 0
    finally:
        svc.stop()


def test_integrity_off_touches_nothing(monkeypatch):
    monkeypatch.delenv(pol.INTEGRITY_ENV, raising=False)
    svc = _svc(ExecutableCache(manifest_path=None), replicas=2)
    try:
        assert svc._integrity is None and all(r.score is None for r in svc._replicas)
        A, B = _problem(seed=90)
        assert _close(svc.submit("gesv", A, B).result(timeout=60), np.linalg.solve(A, B))
        assert not [k for k in metrics.counters() if "integrity" in k or "hedge" in k]
        assert svc.health()["integrity"] is None
        assert not any(abft.ABFT_TAG in k.label for k, _b in svc.cache.entries())
    finally:
        svc.stop()


def test_hedge_group_first_result_wins():
    A, B = _problem(seed=100)
    fut, grp = Future(), _HedgeGroup()
    prim = _Request(routine="gesv", key=None, A=A, B=B, m=12, n=12, nrhs=2, future=fut,
                    hedge_group=grp)
    clone = _Request(routine="gesv", key=None, A=A, B=B, m=12, n=12, nrhs=2, future=fut,
                     is_hedge=True, hedge_group=grp)
    X = np.linalg.solve(A, B)
    _resolve(fut, X, clone)  # the hedge wins
    _resolve(fut, X + 1, prim)  # the primary arrives late: wasted
    assert np.abs(fut.result(timeout=1) - X).max() == 0
    c = metrics.counters()
    assert c.get("serve.hedge.won") == 1 and c.get("serve.hedge.wasted") == 1
    fut2, grp2 = Future(), _HedgeGroup()
    p2 = _Request(routine="gesv", key=None, A=A, B=B, m=12, n=12, nrhs=2, future=fut2,
                  hedge_group=grp2)
    c2 = _Request(routine="gesv", key=None, A=A, B=B, m=12, n=12, nrhs=2, future=fut2,
                  is_hedge=True, hedge_group=grp2)
    _resolve_exc(fut2, NumericalError("lane a died"), req=c2)
    assert not fut2.done()
    _resolve_exc(fut2, NumericalError("lane b died"), req=p2)
    with pytest.raises(NumericalError):
        fut2.result(timeout=1)


def test_straggler_sweep_clones_to_other_lane(shared_cache):
    svc = _svc(shared_cache, replicas=2, start=False, integrity=pol.IntegrityPolicy(
        mode="full", hedge_factor=1.0, hedge_min_age_s=0.0))
    try:
        A, B = _problem(seed=110)
        key = bk.bucket_for("gesv", 12, 12, 2, np.float64, floor=FLOOR, nrhs_floor=NRHS_FLOOR)
        for _ in range(4):
            metrics.observe_hist(f"serve.latency.{key.label}.total", 0.001)
        req = _Request(routine="gesv", key=key, A=A, B=B, m=12, n=12, nrhs=2)
        req.t_submit = time.monotonic() - 0.5  # well past the p99
        svc._replicas[0].q.append(req)
        with svc._cond:
            svc._hedge_stragglers_locked(time.monotonic())
        assert len(svc._replicas[1].q) == 1
        clone = svc._replicas[1].q[0]
        assert clone.is_hedge and clone.hedge_group is req.hedge_group
        assert clone.future is req.future
        assert metrics.counters().get("serve.hedge.sent") == 1
        svc._hedge_last_sweep = 0.0
        with svc._cond:
            svc._hedge_stragglers_locked(time.monotonic())
        assert metrics.counters().get("serve.hedge.sent") == 1  # never hedged twice
        svc.start()
        assert _close(req.future.result(timeout=60), np.linalg.solve(A, B))
        # the twin that lost finishes after the future resolved: its work
        # is counted wasted (or, the clone winning, won) once it lands
        t0 = time.monotonic()
        while (metrics.counters().get("serve.hedge.wasted", 0) < 1
               and time.monotonic() - t0 < 30):
            time.sleep(0.01)
        assert metrics.counters().get("serve.hedge.wasted") == 1
    finally:
        svc.stop()
