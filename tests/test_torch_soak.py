"""The port's soak fabric on the CPU (ROADMAP.md Queue 1 item 7c2a):
every case of tests/test_soak.py on ``slate_tpu_torch.soak`` and the
port's service, then parity with the JAX package on the same seeds:
the generators' rows, ``materialize``'s bytes for gesv / posv / gels in
f64 and f32, specs that load across the two packages, one stream
recorded through a JAX service and a port service (equal rows apart
from ``t_offset``), ``sample_row``'s keys with integrity, tenants and the
factor cache armed, and the repo's stdlib tools (``soak_report.py``,
``metrics_merge.py``) reading the port's own dumps.

Services run on a CPU placement at small buckets (floor 16, nrhs floor
4, n <= 24).  A delivered X is held by the replay engine's own numpy
check (residual <= 1e-6 (max|A| max|X| + max|B|)); the variants the JAX
package's tests skip are held against numpy: a posv row's solved
operand and a gels row (exempt from the residual check, held here to
``numpy.linalg.lstsq``)."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from slate_tpu.aux import metrics as jmetrics
from slate_tpu.aux import spans as jspans
from slate_tpu.integrity import policy as jpol
from slate_tpu.serve.cache import ExecutableCache as JExecutableCache
from slate_tpu.serve.factor_cache import FactorCache as JFactorCache
from slate_tpu.serve.service import SolverService as JSolverService
from slate_tpu.soak import record as jrecord
from slate_tpu.soak import replay as jreplay
from slate_tpu.soak import timeline as jtimeline
from slate_tpu_torch.aux import faults, metrics, spans
from slate_tpu_torch.integrity import policy as ipol
from slate_tpu_torch.ops.hopper import panel_kernels as pk
from slate_tpu_torch.serve import buckets as bk
from slate_tpu_torch.serve import service as serve_service
from slate_tpu_torch.serve.cache import ExecutableCache
from slate_tpu_torch.serve.factor_cache import FactorCache
from slate_tpu_torch.serve.placement import PlacementPolicy
from slate_tpu_torch.serve.service import SolverService, _Request
from slate_tpu_torch.soak import record, replay
from slate_tpu_torch.soak.timeline import TimelineSampler, sample_row

torch.set_num_threads(1)

FLOOR = 16
NRHS_FLOOR = 4
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOOLS = os.path.join(_REPO, "tools")
TENANTS = "gold:weight=4;good:weight=2;free:rate=300,share=0.5;abuser:rate=60,burst=16,share=0.25"


@pytest.fixture(autouse=True)
def _env():
    for m in (metrics, jmetrics):
        m.off()
        m.reset()
        m.on()
    faults.reset()
    pk.reset_launches()
    yield
    faults.reset()
    for m in (metrics, jmetrics):
        m.off()
        m.reset()
    for s, ring in ((spans, spans.RING), (jspans, jspans.DEFAULT_RING)):
        s.on(ring=ring)  # a test here resizes the process-global rings
        s.off()
        s.clear()
    assert serve_service._delivery_taps == []
    assert all(v == 0 for v in pk.LAUNCHES.values()), pk.LAUNCHES


@pytest.fixture(scope="module")
def shared_cache():
    return ExecutableCache(manifest_path=None)


@pytest.fixture(scope="module")
def jax_cache():
    return JExecutableCache(manifest_path=None)


def _ensure(cache, routine, n, batches=(1, 4), dtype=np.float64):
    k = bk.bucket_for(routine, n, n, 2, dtype, floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    cache.ensure_manifest(k, batches)
    cache.ensure_manifest(k.solve_sibling(), batches)
    return k


def _service(shared_cache, replicas=1, **kw):
    defaults = dict(
        cache=shared_cache, batch_max=4, batch_window_s=0.001,
        dim_floor=FLOOR, nrhs_floor=NRHS_FLOOR,
        placement=PlacementPolicy(replicas=replicas, devices=["cpu"]),
    )
    defaults.update(kw)
    return SolverService(**defaults)


def _jservice(jax_cache, **kw):
    defaults = dict(cache=jax_cache, batch_max=4, batch_window_s=0.001,
                    dim_floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    defaults.update(kw)
    return JSolverService(**defaults)


# ---------------------------------------------------------------------------
# generators + materialize (pure, no service)
# ---------------------------------------------------------------------------


def test_generators_deterministic():
    for name, gen in replay.GENERATORS.items():
        a = gen(60, seed=3)
        b = gen(60, seed=3)
        assert a == b, name
        c = gen(60, seed=4)
        assert a != c, name
        assert len(a) == 60 or name == "adversarial_flood", name
        for row in a:
            for f in record.SPEC_FIELDS:
                assert f in row, (name, f)


_GEN_ARGS = [
    ("multitenant", 90, 1, dict(rate_rps=88)),
    ("multitenant", 44, 5, dict(rate_rps=6.0, n_small=2048, n_large=4096, nrhs=16, distinct=4)),
    ("repeated_a", 120, 2, dict(rate_rps=240, distinct=10)),
    ("repeated_a", 36, 3, dict(rate_rps=2.0, n=2048, nrhs=16, distinct=2, routine="posv")),
    ("adversarial_flood", 90, 5, dict(rate_rps=45)),
    ("adversarial_flood", 20, 7, dict(n_flood=4096, n_victim=2048, nrhs=16)),
    ("deadline_storm", 80, 4, dict(rate_rps=40)),
    ("deadline_storm", 20, 4, dict(n=2048, nrhs=16, tight_s=0.05, slack_s=60.0)),
    ("burst", 100, 9, dict()),
    ("burst", 50, 2, dict(base_rps=5.0, burst_rps=50.0, routine="posv", n=24)),
]


@pytest.mark.parametrize("name,requests,seed,kw", _GEN_ARGS)
def test_generators_match_jax(name, requests, seed, kw):
    got = replay.GENERATORS[name](requests, seed=seed, **kw)
    assert got == jreplay.GENERATORS[name](requests, seed=seed, **kw)
    assert replay.warm_spec(got, gap_s=0.01) == jreplay.warm_spec(got, gap_s=0.01)
    other = replay.gen_repeated_a(30, seed=seed + 1)
    assert replay.merge_specs(got, other) == jreplay.merge_specs(got, other)
    assert set(replay.GENERATORS) == set(jreplay.GENERATORS)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("routine,shape", [("gesv", [24, 24, 2]), ("posv", [12, 12, 3]),
                                           ("gels", [40, 12, 2]), ("gesv", [700, 700, 5])])
def test_materialize_bytes_match_jax(routine, shape, dtype):
    base = replay.gen_repeated_a(3, seed=6, distinct=1, routine=routine)
    cache, jcache = {}, {}
    for row in base:
        row = dict(row, bucket_shape=shape, dtype=dtype)
        for seed in (0, 3):
            A, B = replay.materialize(row, seed=seed, cache=cache)
            jA, jB = jreplay.materialize(row, seed=seed, cache=jcache)
            assert A.dtype == jA.dtype == np.dtype(dtype) and A.shape == tuple(shape[:2])
            assert B.shape == (shape[0], shape[2])
            assert A.tobytes() == jA.tobytes() and B.tobytes() == jB.tobytes()
    assert sorted(cache) == sorted(jcache) and len(cache) == 2  # one A a replay seed


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("routine,shape", [("gesv", [40, 40, 3]), ("posv", [33, 33, 2]),
                                           ("gels", [70, 20, 5])])
def test_materialize_device_path_bytes_match_jax(routine, shape, dtype):
    """With a ``device`` A's integer rounds run in torch (exact) and the
    uniforms return for numpy's normal transform: the same bytes, here
    through torch on the CPU, and the A it caches is the one a later
    host call reads."""
    row = dict(replay.gen_repeated_a(1, seed=5, routine=routine)[0], bucket_shape=shape,
               dtype=dtype)
    for seed in (0, 2):
        cache: dict = {}
        got = replay.materialize(row, seed=seed, cache=cache, device="cpu")
        ref = jreplay.materialize(row, seed=seed)
        assert all(a.dtype == b.dtype and a.tobytes() == b.tobytes() for a, b in zip(got, ref))
        assert replay.materialize(row, seed=seed, cache=cache)[0] is got[0]
    with pytest.raises(ValueError):
        replay.materialize(dict(row, dtype="complex128"), device="cpu")


def test_materialize_repeat_structure():
    rows = replay.gen_repeated_a(12, seed=1, distinct=3)
    cache = {}
    groups = {}
    for r in rows:
        A, B = replay.materialize(r, seed=0, cache=cache)
        groups.setdefault(r["repeat_fp"], []).append((A, B))
    assert len(groups) == 3
    for fp, items in groups.items():
        a0 = items[0][0]
        for A, B in items[1:]:
            # same repeat_fp -> byte-identical matrix, fresh rhs
            assert A.tobytes() == a0.tobytes(), fp
            assert B.tobytes() != items[0][1].tobytes(), fp
    mats = {items[0][0].tobytes() for items in groups.values()}
    assert len(mats) == 3  # distinct groups get distinct matrices
    assert len(cache) == 3  # the cache memoizes A per group


def test_materialize_solvable_and_seed_sensitivity():
    row = replay.gen_multitenant(1, seed=0)[0]
    A0, B0 = replay.materialize(row, seed=0)
    A1, _ = replay.materialize(row, seed=1)
    assert A0.tobytes() != A1.tobytes()  # replay seed perturbs operands
    X = np.linalg.solve(A0, B0)
    assert np.all(np.isfinite(X))
    assert replay._residual_ok(row["routine"], A0, B0, X)
    assert not replay._residual_ok(row["routine"], A0, B0, X * 2 + 1)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_residual_check_posv_operand_and_gels_against_numpy(dtype):
    """The variants the JAX package's tests skip: posv's solved operand is
    the symmetrized lower triangle (junk above the diagonal must not move
    the verdict), and gels is exempt from the residual check (held here to
    numpy's least squares instead)."""
    row = dict(replay.gen_repeated_a(1, seed=2, n=20, routine="posv")[0], dtype=dtype)
    A, B = replay.materialize(row)
    assert np.array_equal(A, A.T) and np.all(np.linalg.eigvalsh(A.astype(np.float64)) > 0)
    X = np.linalg.solve(A, B)
    assert replay._residual_ok("posv", A, B, X)
    junk = np.tril(A) + np.triu(np.full_like(A, 1e3), 1)  # only the lower half is read
    assert replay._residual_ok("posv", junk, B, X)
    assert not replay._residual_ok("gesv", junk, B, X)
    assert not replay._residual_ok("posv", A, B, X + 1e-2)
    assert not replay._residual_ok("posv", A, B, np.where(X > 0, np.inf, X))
    row = dict(replay.gen_repeated_a(1, seed=2, n=12, routine="gels")[0],
               bucket_shape=[30, 12, 2], dtype=dtype)
    A, B = replay.materialize(row)
    X = np.linalg.lstsq(A, B, rcond=None)[0]
    assert np.abs(A @ X - B).max() > 1e-3  # not ~0 by construction ...
    assert replay._residual_ok("gels", A, B, X)  # ... so exempt, but
    assert not replay._residual_ok("gels", A, B, X * np.nan)  # never non-finite


def test_warm_spec_one_row_per_pool():
    spec = replay.merge_specs(
        replay.gen_repeated_a(40, seed=2, distinct=4),
        replay.gen_multitenant(40, seed=1, distinct=4),
    )
    warm = replay.warm_spec(spec, gap_s=0.01)
    fps = [w["repeat_fp"] for w in warm]
    assert len(fps) == len(set(fps))  # one row per pool
    assert set(fps) == {r["repeat_fp"] for r in spec if r["repeat_fp"]}
    assert all(w["deadline_s"] is None for w in warm)
    offs = [w["t_offset"] for w in warm]
    assert offs == sorted(offs)
    assert offs[-1] == pytest.approx(0.01 * (len(warm) - 1))


def test_spec_save_load_roundtrip(tmp_path):
    rows = replay.gen_deadline_storm(25, seed=9)
    path = str(tmp_path / "spec.jsonl")
    record.save(rows, path, source="synth")
    back = record.load(path)
    stripped = [{k: v for k, v in r.items() if k != "type"} for r in back]
    assert stripped == sorted(rows, key=lambda r: r["t_offset"])
    head = json.loads(open(path).read().splitlines()[0])
    assert head["type"] == "spec_meta"
    assert head["count"] == 25
    assert head["source"] == "synth"
    # a newer spec version must refuse loudly, not misparse silently
    with open(path, "w") as f:
        f.write(json.dumps({
            "type": "spec_meta", "version": record.SPEC_VERSION + 1,
            "count": 0,
        }) + "\n")
    with pytest.raises(ValueError, match="newer"):
        record.load(path)


def test_spec_loads_across_packages(tmp_path):
    rows = replay.merge_specs(replay.gen_multitenant(30, seed=2),
                              replay.gen_deadline_storm(12, seed=3))
    ours, theirs = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    record.save(rows, ours, source="synth")
    jrecord.save(rows, theirs, source="synth")
    assert open(ours).read() == open(theirs).read()
    for path in (ours, theirs):
        assert record.load(path) == jrecord.load(path)
        assert record.mix_histogram(record.load(path)) == jrecord.mix_histogram(
            jrecord.load(path))
    assert record.SPEC_VERSION == jrecord.SPEC_VERSION
    assert record.SPEC_FIELDS == jrecord.SPEC_FIELDS
    for fp, k in ((None, 5), ("ab" * 32, 7)):
        assert record.matrix_seed_for(fp, k) == jrecord.matrix_seed_for(fp, k)


def test_mix_histogram():
    rows = replay.gen_multitenant(40, seed=1, distinct=4)
    mix = record.mix_histogram(rows)
    assert sum(mix["tenants"].values()) == 40
    assert set(mix["tenants"]) == {"gold", "free"}
    assert mix["tenants"]["free"] == 10  # every 4th row
    assert sum(mix["priorities"].values()) == 40
    assert sum(mix["repeat_groups"].values()) == 40
    assert all(":" in s for s in mix["shapes"])
    assert mix == jrecord.mix_histogram(rows)


# ---------------------------------------------------------------------------
# span-ring pressure + metrics timeline primitives
# ---------------------------------------------------------------------------


def test_spans_pressure():
    spans.on(ring=8)
    spans.clear()
    p = spans.pressure()
    assert p["capacity"] == 8 == spans.capacity()
    assert p["size"] == 0
    assert p["evicted"] == 0
    assert p["window_s"] == 0.0
    for i in range(12):
        spans.end(spans.start("request"))
    p = spans.pressure()
    assert p["size"] == 8
    assert p["evicted"] == 4
    assert p["window_s"] >= 0.0
    spans.on()  # a bare re-enable keeps the capacity
    assert spans.capacity() == 8
    spans.on(ring=16)  # resizing keeps the newest spans in order
    assert spans.pressure()["size"] == 8 and spans.capacity() == 16


def test_metrics_timeline_rows(tmp_path):
    metrics.record_timeline({"queue_depth": 3, "ready": True})
    metrics.record_timeline({"queue_depth": 5, "t": 1.25})
    rows = metrics.timeline()
    assert len(rows) == 2
    assert rows[0]["queue_depth"] == 3
    assert "t" in rows[0]  # stamped at record time when absent
    assert rows[1]["t"] == 1.25
    path = str(tmp_path / "m.jsonl")
    metrics.dump(path)
    dumped = [
        json.loads(line) for line in open(path)
        if json.loads(line).get("type") == "timeline"
    ]
    assert len(dumped) == 2
    assert dumped[1]["queue_depth"] == 5
    metrics.reset()
    assert metrics.timeline() == []


def test_metrics_timeline_off_is_free():
    metrics.off()
    metrics.record_timeline({"queue_depth": 1})
    metrics.on()
    assert metrics.timeline() == []


# ---------------------------------------------------------------------------
# recorder + replay + timeline against a live service
# ---------------------------------------------------------------------------


def test_recorder_tap_and_zero_overhead_off(shared_cache):
    _ensure(shared_cache, "gesv", 12)
    assert serve_service._delivery_taps == []  # off by default
    svc = _service(shared_cache, factor_cache=FactorCache(max_entries=8))

    def broken(req, outcome):  # a tap that raises never breaks delivery
        raise RuntimeError("tap")

    try:
        rng = np.random.default_rng(0)
        A = rng.standard_normal((12, 12)) + 12 * np.eye(12)
        rec = record.Recorder()
        serve_service.add_delivery_tap(broken)
        with rec:
            assert len(serve_service._delivery_taps) == 2
            futs = [
                svc.submit("gesv", A, rng.standard_normal((12, 2)),
                           deadline=30.0)
                for _ in range(3)
            ]
            for f in futs:
                f.result(timeout=300)
        serve_service.remove_delivery_tap(broken)
        assert serve_service._delivery_taps == []  # detached
        rows = rec.rows()
        assert len(rows) == len(rec) == 3  # delivered + typed errors
        for r in rows:
            assert r["routine"] == "gesv"
            assert r["bucket_shape"] == [12, 12, 2]
            assert r["dtype"] == "float64"
            assert r["deadline_s"] == pytest.approx(30.0, abs=0.5)
            assert r["repeat_fp"]  # factor cache armed -> fingerprinted
        # same A -> same fingerprint -> same matrix_seed (the recorded
        # spec preserves the same-A burst for the factor cache)
        assert len({r["repeat_fp"] for r in rows}) == 1
        assert len({r["matrix_seed"] for r in rows}) == 1
        assert len({r["rhs_seed"] for r in rows}) == 3
        # resolutions after detach are not recorded
        svc.submit("gesv", A, rng.standard_normal((12, 2))).result(
            timeout=300)
        assert len(rec.rows()) == 3
    finally:
        serve_service.remove_delivery_tap(broken)
        svc.stop()


@pytest.mark.parametrize("dtype,name", [(np.float32, "float32"), (torch.float32, "float32"),
                                        (torch.float64, "float64")])
def test_recorder_dtype_is_the_numpy_name(dtype, name):
    """A request whose operand is a tensor records the numpy name
    ("float32"), never "torch.float32", and never raises inside the tap
    (the service would swallow it and the row would be lost)."""
    A = (torch.eye(3, dtype=dtype) if isinstance(dtype, torch.dtype)
         else np.eye(3, dtype=dtype))
    req = _Request(routine="gesv", key=None, A=A, B=A[:, :1], m=3, n=3, nrhs=1,
                   tenant="gold", priority=bk.PRIO_HIGH)
    rec = record.Recorder()
    rec._tap(req, "ok")
    rec._tap(req, "ok")  # a second resolution of the same future is deduped
    [row] = rec.rows()
    assert row["dtype"] == name and row["priority"] == "high"
    assert row["t_offset"] == 0.0 and row["deadline_s"] is None
    assert row["matrix_seed"] == record.matrix_seed_for(None, 0)


def test_replay_reconciles_and_records_round_trip(shared_cache):
    _ensure(shared_cache, "gesv", 12)
    svc = _service(shared_cache, factor_cache=FactorCache(max_entries=8))
    spans.on(ring=4096)
    try:
        spans.clear()
        spec = replay.gen_repeated_a(30, seed=5, rate_rps=500, distinct=2)
        rec = record.Recorder()
        with rec:
            res = replay.replay(svc, spec, speed=2.0, seed=0)
        assert res["submitted"] == 30
        assert res["submitted"] == (
            res["delivered"] + res["typed_errors"] + res["refused"]
        )
        assert res["bad_results"] == 0
        assert res["p50_s"] is not None
        c = metrics.counters()
        assert c["soak.submitted"] == 30
        assert c["soak.delivered"] == res["delivered"]
        assert c["serve.requests"] == c["soak.submitted"] - c.get("soak.refused", 0)
        assert len(rec.rows()) == res["delivered"] + res["typed_errors"]
        assert spans.pressure()["evicted"] == 0  # the audit below is real
        assert replay.orphan_spans() == 0
        assert metrics.gauges()["soak.orphan_spans"] == 0
        # ring -> spec reconstruction sees the same request stream
        ring_rows = record.from_ring()
        assert len(ring_rows) >= res["delivered"]
        assert all(r["routine"] == "gesv" for r in ring_rows)
        assert all(r["bucket_shape"] == [16, 16, 4] for r in ring_rows)  # bucket-rounded
        assert ring_rows == jrecord.from_ring(spans.snapshot())
    finally:
        svc.stop()


def test_orphan_spans_counts_an_open_request():
    spans.on(ring=64)
    spans.clear()
    done = spans.start("request", trace="t1")
    spans.end(spans.start("queued", trace="t1", parent=done))
    spans.end(done)
    spans.end(spans.start("queued", trace="t2"))  # its root never closed
    assert replay.orphan_spans() == 1
    assert metrics.gauges()["soak.orphan_spans"] == 1


def test_timeline_sampler(shared_cache):
    _ensure(shared_cache, "gesv", 12)
    svc = _service(shared_cache)
    try:
        with TimelineSampler(svc, period_s=0.02) as sampler:
            time.sleep(0.15)
        assert sampler.errors == 0
        rows = metrics.timeline()
        assert len(rows) >= 4  # baseline + cadence + terminal
        for r in rows:
            assert isinstance(r["ready"], bool)
            assert isinstance(r["queue_depth"], int)
            assert isinstance(r["breakers_open"], int)
            assert "t" in r
        ts = [r["t"] for r in rows]
        assert ts == sorted(ts)
    finally:
        svc.stop()


def test_timeline_sampler_counts_errors_and_never_raises():
    class Broken:
        def health(self):
            raise RuntimeError("probe")

    s = TimelineSampler(Broken(), period_s=0.01).start()
    time.sleep(0.05)
    s.stop()
    assert s.errors >= 2 and metrics.timeline() == []


def test_sample_row_with_planes_armed(shared_cache):
    _ensure(shared_cache, "gesv", 12)
    svc = _service(
        shared_cache,
        factor_cache=FactorCache(max_entries=8),
        tenants="gold:weight=4;free:rate=100,share=0.5",
        adaptive=True, latency_budget_s=0.5,
        integrity=ipol.parse_spec("full"),
    )
    spans.on(ring=1024)
    try:
        row = sample_row(svc)
        assert isinstance(row["quarantined"], int)
        assert isinstance(row["ring_evicted"], int)
        assert isinstance(row["factor_cache_bytes"], int)
        assert "overload_level" in row
    finally:
        svc.stop()


def test_sample_row_keys_match_jax(shared_cache, jax_cache):
    """Both services with integrity, tenants, adaptive admission and the
    factor cache armed and one request served: the same row keys and
    value types."""
    kw = dict(tenants="gold:weight=4;free:rate=100,share=0.5", adaptive=True,
              latency_budget_s=0.5)
    svc = _service(shared_cache, factor_cache=FactorCache(max_entries=8),
                   integrity=ipol.parse_spec("full"), **kw)
    jsvc = _jservice(jax_cache, factor_cache=JFactorCache(max_entries=8),
                     integrity=jpol.parse_spec("full"), **kw)
    spans.on(ring=1024)
    jspans.on(ring=1024)
    try:
        A = np.eye(12) * 12 + np.random.default_rng(3).standard_normal((12, 12))
        for s in (svc, jsvc):
            s.submit("gesv", A, np.ones((12, 2)), tenant="gold").result(timeout=300)
        row, jrow = sample_row(svc), jtimeline.sample_row(jsvc)
        assert sorted(row) == sorted(jrow)
        assert {k: type(v) for k, v in row.items()} == {k: type(v) for k, v in jrow.items()}
        assert row["factor_cache_entries"] == jrow["factor_cache_entries"] == 1
        # unarmed, both rows drop the same optional sections
        plain, jplain = _service(shared_cache), _jservice(jax_cache)
        try:
            assert sorted(sample_row(plain)) == sorted(jtimeline.sample_row(jplain))
        finally:
            plain.stop()
            jplain.stop()
    finally:
        svc.stop()
        jsvc.stop()


def test_health_all_planes_armed_sections_and_latency(shared_cache, jax_cache):
    """health() with EVERY plane armed at once: all documented sections
    present with stable types (the JAX package's keys, less the sharded
    lane (item 8)), and the probe stays cheap enough to poll."""
    _ensure(shared_cache, "gesv", 12)
    kw = dict(tenants="gold:weight=4;free:rate=100,share=0.5", adaptive=True,
              latency_budget_s=0.5)
    svc = _service(
        shared_cache,
        factor_cache=FactorCache(max_entries=8),
        integrity=ipol.parse_spec("full,hedge=1.5,cooldown=0.5"), **kw,
    )
    jsvc = _jservice(jax_cache, factor_cache=JFactorCache(max_entries=8),
                     integrity=jpol.parse_spec("full,hedge=1.5,cooldown=0.5"), **kw)
    spans.on(ring=1024)
    try:
        rng = np.random.default_rng(1)
        A = rng.standard_normal((12, 12)) + 12 * np.eye(12)
        for tenant in ("gold", "free"):
            svc.submit("gesv", A, rng.standard_normal((12, 2)),
                       tenant=tenant).result(timeout=300)
        t0 = time.monotonic()
        h = svc.health()
        probe_s = time.monotonic() - t0
        assert probe_s < 0.25, f"health() took {probe_s:.3f}s"
        assert set(h) == set(jsvc.health()) - {"sharded"}
        assert h["capacity"] is None  # the scaler is unarmed
        for key in ("ok", "phase", "ready", "restore", "integrity",
                    "running", "worker_alive", "worker_restarts",
                    "queue_depth", "queue_limit", "inflight", "breakers",
                    "open_buckets", "replicas", "latency",
                    "slo_burn", "trace_ring", "cost", "devices",
                    "factor_cache", "tenants", "admission",
                    "failures_60s", "failure_rate_60s", "uptime_s"):
            assert key in h, key
        assert isinstance(h["ready"], bool)
        assert isinstance(h["queue_depth"], int)
        assert isinstance(h["replicas"], list)
        # every armed plane populates its section (None = plane off)
        assert h["integrity"] is not None
        assert h["integrity"]["policy"].startswith("full")
        assert h["factor_cache"] is not None
        assert isinstance(h["factor_cache"]["entries"], int)
        assert h["tenants"] is not None
        assert h["admission"] is not None
        assert h["trace_ring"] is not None
        assert h["trace_ring"] == spans.pressure()
        assert isinstance(h["latency"], dict) and h["latency"]
        for row in h["latency"].values():
            assert set(row) >= {"count", "p50", "p95", "p99"}
    finally:
        svc.stop()
        jsvc.stop()


def _stream(routine_rows, submit):
    """One request at a time (a deterministic delivery order, so the
    recorded ordinals and rhs seeds agree across services)."""
    for routine, A, B, kw in routine_rows:
        submit(routine, A, B, **kw).result(timeout=300)


def test_recorded_rows_match_jax(shared_cache, jax_cache):
    rng = np.random.default_rng(11)
    G = rng.standard_normal((12, 12))
    gesv_a, posv_a = G + 12 * np.eye(12), G @ G.T + 12 * np.eye(12)
    tall = rng.standard_normal((20, 12))
    reqs = []
    for k in range(12):
        if k % 4 == 1:
            routine, A = "posv", posv_a
        elif k % 6 == 5:
            routine, A = "gels", tall
        else:
            routine, A = "gesv", gesv_a if k < 9 else gesv_a.astype(np.float32)
        kw = dict(tenant=("gold", "free")[k % 2], priority=("high", "low", None)[k % 3])
        if k % 5 == 2:
            kw["deadline"] = 40.0
        reqs.append((routine, A, rng.standard_normal((A.shape[0], 2)).astype(A.dtype), kw))
    out = []
    for mk, rec in ((lambda: _service(shared_cache, factor_cache=FactorCache(max_entries=8)),
                     record.Recorder),
                    (lambda: _jservice(jax_cache, factor_cache=JFactorCache(max_entries=8)),
                     jrecord.Recorder)):
        svc = mk()
        try:
            r = rec()
            with r:
                _stream(reqs, svc.submit)
            out.append(r.rows())
        finally:
            svc.stop()
    ours, theirs = out
    assert len(ours) == len(theirs) == 12
    for a, b in zip(ours, theirs):
        # deadline - t_submit: both clocks read at submit, a scheduling gap apart
        assert a.pop("deadline_s") == pytest.approx(b.pop("deadline_s"), abs=0.05)
        a.pop("t_offset"), b.pop("t_offset")
        assert a == b
    assert {r["dtype"] for r in ours} == {"float64", "float32"}
    assert all(r["repeat_fp"] for r in ours)  # every routine fingerprinted


def test_replay_serves_on_the_placement_it_was_given(shared_cache):
    """A CPU placement's lanes serve the replay (no CUDA lane appears)."""
    svc = _service(shared_cache)
    try:
        assert [r["device"] for r in svc.health()["replicas"]] == ["cpu"]
        res = replay.replay(svc, replay.gen_repeated_a(6, seed=1, rate_rps=1e4), speed=1e6)
        assert res["delivered"] == 6 and res["bad_results"] == 0
    finally:
        svc.stop()


class _SlowService:
    """A stand-in service: the k-th future resolves ``delays[k]`` seconds
    after its submit (never, for None), off the caller's thread."""

    def __init__(self, delays):
        self.delays, self.timers = list(delays), []

    def submit(self, routine, A, B, deadline=None, tenant=None, priority=None):
        import threading
        from concurrent.futures import Future

        fut = Future()
        delay = self.delays[len(self.timers) % len(self.delays)]
        if delay is not None:
            t = threading.Timer(delay, fut.set_result, (np.linalg.solve(A, B),))
            t.start()
            self.timers.append(t)
        return fut


def test_replay_is_open_loop_and_stamps_latency_at_resolution():
    """The pacer never waits on a completion (ten submits in well under
    one service delay), and a request's latency is stamped when its future
    resolves: nine fast requests behind one slow head read 0.1 s, not the
    0.6 s at which the drain loop reaches them."""
    svc = _SlowService([0.6] + [0.1] * 9)
    rows = [dict(r, t_offset=0.005 * k) for k, r in
            enumerate(replay.gen_repeated_a(10, seed=1, distinct=2))]
    res = replay.replay(svc, rows, seed=0)
    for t in svc.timers:
        t.join(5)
    assert res["delivered"] == 10 and res["bad_results"] == 0
    assert res["submit_wall_s"] < 0.2
    assert 0.05 <= res["p50_s"] < 0.3 <= 0.55 <= res["p99_s"] < 1.0


def test_replay_checks_results_after_the_window(monkeypatch):
    """The client's residual checks run only once every future has
    resolved (they never compete with the service inside the window):
    the delivered rate is taken to the last resolution, before the
    checks, and the largest reading is reported."""
    svc = _SlowService([0.05, 0.3])
    futs = []
    submit = svc.submit
    monkeypatch.setattr(svc, "submit", lambda *a, **k: futs.append(submit(*a, **k)) or futs[-1])
    rows = [dict(r, t_offset=0.0) for r in replay.gen_repeated_a(6, seed=2, distinct=2)]
    seen = []
    real = replay._residual

    def spy(routine, A, B, X):
        seen.append(all(f.done() for f in futs))
        time.sleep(0.05)
        return real(routine, A, B, X)

    monkeypatch.setattr(replay, "_residual", spy)
    res = replay.replay(svc, rows, seed=0)
    for t in svc.timers:
        t.join(5)
    assert seen == [True] * 6
    assert res["delivered"] == 6 and res["bad_results"] == 0
    assert 0.3 <= res["resolve_wall_s"] < res["wall_s"] - 0.25
    assert res["delivered_per_s"] == pytest.approx(6 / res["resolve_wall_s"], rel=1e-2)
    assert 0 < res["max_residual"] <= replay.RESIDUAL_TOL


def test_replay_turns_a_hang_into_a_loud_failure():
    from concurrent.futures import TimeoutError as FutureTimeout

    with pytest.raises(FutureTimeout):
        replay.replay(_SlowService([None]), replay.gen_repeated_a(2, seed=1), timeout_s=0.05)


# ---------------------------------------------------------------------------
# tools: metrics_merge + soak_report (subprocess, stdlib-only contract)
# ---------------------------------------------------------------------------


def _hist_row(name, values):
    sys.path.insert(0, _TOOLS)
    try:
        import metrics_merge as mm
    finally:
        sys.path.pop(0)
    counts = [0] * (len(mm.HIST_EDGES) + 1)
    for v in values:
        i = 0
        while i < len(mm.HIST_EDGES) and v > mm.HIST_EDGES[i]:
            i += 1
        counts[i] += 1
    ordered = sorted(values)
    return {
        "type": "hist", "name": name, "count": len(values),
        "total_s": round(sum(values), 6), "min_s": min(values),
        "max_s": max(values),
        "p50": ordered[len(ordered) // 2], "p95": ordered[-1],
        "p99": ordered[-1],
        "buckets": [
            ["inf" if i >= len(mm.HIST_EDGES)
             else float(f"{mm.HIST_EDGES[i]:.9g}"), k]
            for i, k in enumerate(counts) if k
        ],
    }


def _write_jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _tool(name, *args):
    return subprocess.run(
        [sys.executable, os.path.join(_TOOLS, name), *args],
        capture_output=True, text=True, timeout=120)


def test_metrics_merge(tmp_path):
    a = str(tmp_path / "a.jsonl")
    b = str(tmp_path / "b.jsonl")
    merged = str(tmp_path / "m.jsonl")
    _write_jsonl(a, [
        {"type": "meta", "schema": 1},
        {"type": "counter", "name": "soak.submitted", "value": 10},
        {"type": "gauge", "name": "g", "value": 1},
        {"type": "timer", "name": "t", "count": 2, "total_s": 1.0,
         "min_s": 0.4, "max_s": 0.6},
        _hist_row("serve.latency.x.total", [0.01, 0.02, 0.04]),
        {"type": "timeline", "t": 0.5, "queue_depth": 1},
        {"type": "event", "name": "debug", "t": 0.1},
    ])
    _write_jsonl(b, [
        {"type": "counter", "name": "soak.submitted", "value": 5},
        {"type": "gauge", "name": "g", "value": 7},
        {"type": "timer", "name": "t", "count": 1, "total_s": 0.2,
         "min_s": 0.2, "max_s": 0.2},
        _hist_row("serve.latency.x.total", [0.08]),
        {"type": "timeline", "t": 0.25, "queue_depth": 9},
    ])
    assert _tool("metrics_merge.py", a, b, "-o", merged).returncode == 0
    rows = [json.loads(line) for line in open(merged)]
    by = {}
    for r in rows:
        by.setdefault(r["type"], []).append(r)
    assert "event" not in by  # dropped
    [meta] = by["meta"]
    assert meta["merged_from"] == ["a.jsonl", "b.jsonl"]
    [ctr] = by["counter"]
    assert ctr["value"] == 15  # counters sum
    [g] = by["gauge"]
    assert g["value"] == 7  # last wins
    [t] = by["timer"]
    assert (t["count"], t["total_s"], t["min_s"], t["max_s"]) == (
        3, 1.2, 0.2, 0.6)
    [h] = by["hist"]
    assert h["count"] == 4
    assert sum(k for _le, k in h["buckets"]) == 4
    assert 0.01 <= h["p50"] <= 0.04  # re-ranked from merged buckets
    assert 0.04 < h["p99"] <= 0.08
    tl = by["timeline"]
    assert [r["t"] for r in tl] == [0.25, 0.5]  # re-sorted
    assert tl[0]["src"] == "b.jsonl"
    # an off-lattice edge is a schema violation, not a silent misfile
    bad = str(tmp_path / "bad.jsonl")
    _write_jsonl(bad, [
        {"type": "hist", "name": "h", "count": 1, "total_s": 1.0,
         "min_s": 1.0, "max_s": 1.0, "buckets": [[0.007, 1]]},
    ])
    assert _tool("metrics_merge.py", bad, "-o", str(tmp_path / "out.jsonl")).returncode != 0


def _verdict_rows(submitted=100, delivered=90, typed=4, refused=6,
                  bad=0, orphans=0, compiles=0, serve_requests=None,
                  timeline_n=5, p99=0.05):
    if serve_requests is None:
        serve_requests = submitted - refused
    rows = [
        {"type": "meta", "schema": 1},
        {"type": "counter", "name": "soak.submitted", "value": submitted},
        {"type": "counter", "name": "soak.delivered", "value": delivered},
        {"type": "counter", "name": "soak.typed_errors", "value": typed},
        {"type": "counter", "name": "soak.refused", "value": refused},
        {"type": "counter", "name": "soak.bad_results", "value": bad},
        {"type": "counter", "name": "serve.requests",
         "value": serve_requests},
        {"type": "counter", "name": "jit.compilations", "value": compiles},
        {"type": "gauge", "name": "soak.orphan_spans", "value": orphans},
        _hist_row("serve.latency.gesv.16x16x4.float64.total",
                  [p99 / 2, p99 / 2, p99]),
    ]
    rows += [
        {"type": "timeline", "t": 0.1 * i, "ready": True,
         "breakers_open": 0}
        for i in range(timeline_n)
    ]
    return rows


def _report(path, *extra):
    return _tool("soak_report.py", path, *extra).returncode


def test_soak_report_verdicts(tmp_path):
    ok = str(tmp_path / "ok.jsonl")
    _write_jsonl(ok, _verdict_rows())
    assert _report(ok, "--p99-budget-ms", "200") == 0

    # each violation flips the verdict on its own
    cases = {
        "unaccounted.jsonl": _verdict_rows(delivered=89),
        "escape.jsonl": _verdict_rows(bad=3),
        "orphan.jsonl": _verdict_rows(orphans=2),
        "compile.jsonl": _verdict_rows(compiles=1),
        "admission.jsonl": _verdict_rows(serve_requests=80),
        "tail.jsonl": _verdict_rows(p99=5.0),
    }
    for name, rows in cases.items():
        path = str(tmp_path / name)
        _write_jsonl(path, rows)
        assert _report(path, "--p99-budget-ms", "200") == 1, name

    # a run that never recovered from a disruption is flagged
    stuck = _verdict_rows()
    stuck += [{"type": "timeline", "t": 9.0, "ready": True,
               "breakers_open": 2}]
    path = str(tmp_path / "stuck.jsonl")
    _write_jsonl(path, stuck)
    assert _report(path, "--p99-budget-ms", "200") == 1

    # a disruption that CLOSED passes (and obeys --max-recovery-s)
    healed = _verdict_rows()
    healed += [
        {"type": "timeline", "t": 9.0, "ready": True, "breakers_open": 2},
        {"type": "timeline", "t": 9.2, "ready": True, "breakers_open": 0},
    ]
    path = str(tmp_path / "healed.jsonl")
    _write_jsonl(path, healed)
    assert _report(path, "--p99-budget-ms", "200") == 0
    assert _report(path, "--p99-budget-ms", "200",
                   "--max-recovery-s", "0.1") == 1

    # not a soak JSONL -> unusable input, exit 2
    empty = str(tmp_path / "empty.jsonl")
    _write_jsonl(empty, [{"type": "meta", "schema": 1}])
    assert _report(empty) == 2


def test_soak_report_timeline_floor(tmp_path):
    path = str(tmp_path / "thin.jsonl")
    _write_jsonl(path, _verdict_rows(timeline_n=1))
    assert _report(path, "--min-timeline-rows", "5") == 1
    assert _report(path, "--min-timeline-rows", "1") == 0


# ---------------------------------------------------------------------------
# the drill on the port at the JAX gate's sizes, judged by the tools
# ---------------------------------------------------------------------------

_DRILL_FAULTS = "latency:every=3,ms=2;sdc_solve:every=11,seed=3;worker_death:every=7"


def _drill(shared_cache, path, requests=60):
    """A cut of run_tests.py's soak drill on the port: two lanes, every
    plane armed, the warm prelude then metrics reset, a replay under
    latency / SDC / worker-death faults with the recorder and the
    timeline on, the orphan audit on a ring that did not evict."""
    for rt, n in (("gesv", 12), ("posv", 12), ("gesv", 24)):
        _ensure(shared_cache, rt, n)
    svc = _service(shared_cache, replicas=2, retry_backoff_s=0.002, breaker_cooldown_s=0.02,
                   factor_cache=FactorCache(max_entries=64), tenants=TENANTS, adaptive=True,
                   latency_budget_s=0.5,
                   integrity=ipol.parse_spec("full,hedge=1.5,cooldown=0.25"))
    spans.on(ring=65536)
    try:
        svc.warmup()
        spec = replay.merge_specs(
            replay.gen_repeated_a(requests // 2, seed=2, rate_rps=60, distinct=3),
            replay.gen_multitenant(requests // 4, seed=1, rate_rps=30),
            replay.gen_deadline_storm(requests // 8, seed=4, rate_rps=15, slack_s=30.0),
            replay.gen_adversarial_flood(requests - requests // 2 - requests // 4
                                         - requests // 8, seed=5, rate_rps=15),
        )
        assert len(spec) == requests
        replay.replay(svc, replay.warm_spec(spec, gap_s=0.001), speed=1.0, seed=0)
        metrics.reset()
        faults.configure(_DRILL_FAULTS)
        faults.on()
        rec = record.Recorder()
        with rec, TimelineSampler(svc, period_s=0.01) as sampler:
            res = replay.replay(svc, spec, speed=1.0, seed=0)
        faults.reset()
        assert sampler.errors == 0
        assert len(rec) == res["delivered"] + res["typed_errors"], (len(rec), res)
        assert spans.pressure()["evicted"] == 0
        assert replay.orphan_spans() == 0
        svc.stop(drain=True, drain_timeout=60)
        c = metrics.counters()
        assert c["soak.submitted"] == requests == (
            res["delivered"] + res["typed_errors"] + res["refused"])
        assert c["serve.requests"] == c["soak.submitted"] - c.get("soak.refused", 0)
        metrics.dump(path)
        return res, c
    finally:
        svc.stop()


def test_soak_report_passes_a_port_drill(shared_cache, tmp_path):
    path = str(tmp_path / "soak.jsonl")
    res, c = _drill(shared_cache, path)
    assert res["bad_results"] == 0
    assert c["faults.injected.sdc_solve"] >= 1 and c["faults.injected.worker_death"] >= 1
    assert c["faults.injected.latency"] >= 1
    out = _tool("soak_report.py", path, "--p99-budget-ms", "2000",
                "--tenant-p99-budget-ms", "2000", "--min-timeline-rows", "2",
                "--min-delivered", "12")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "fault containment" in out.stdout and "orphan traces" in out.stdout
    # the merge tool reads two port dumps: counters sum, timelines interleave
    other = str(tmp_path / "other.jsonl")
    metrics.reset()
    metrics.inc("soak.submitted", 7)
    metrics.record_timeline({"queue_depth": 0, "ready": True})
    metrics.dump(other)
    merged = str(tmp_path / "merged.jsonl")
    assert _tool("metrics_merge.py", path, other, "-o", merged).returncode == 0
    rows = [json.loads(line) for line in open(merged)]
    sub = [r for r in rows if r["type"] == "counter" and r["name"] == "soak.submitted"]
    assert [r["value"] for r in sub] == [c["soak.submitted"] + 7]
    tl = [r for r in rows if r["type"] == "timeline"]
    assert len(tl) >= 3 and {r["src"] for r in tl} == {"soak.jsonl", "other.jsonl"}
    hists = [r for r in rows if r["type"] == "hist" and r["name"].startswith("serve.latency.")]
    assert hists and all(r["count"] > 0 for r in hists)


def test_soak_report_flags_the_escape_stream(shared_cache, tmp_path):
    """The same SDC with the integrity plane and the factor cache off:
    wrong X reach the client, and the report must exit non-zero."""
    _ensure(shared_cache, "gesv", 12)
    svc = _service(shared_cache, replicas=2, factor_cache=False, integrity=False)
    spans.on(ring=8192)
    try:
        assert svc._integrity is None and svc.factor_cache is None
        svc.warmup()
        metrics.reset()
        faults.configure("sdc_solve:every=7,seed=5")
        faults.on()
        with TimelineSampler(svc, period_s=0.01) as sampler:
            res = replay.replay(svc, replay.gen_repeated_a(40, seed=7, rate_rps=400,
                                                           distinct=4), seed=0)
        faults.reset()
        assert sampler.errors == 0
        assert spans.pressure()["evicted"] == 0 and replay.orphan_spans() == 0
        svc.stop(drain=True, drain_timeout=60)
        path = str(tmp_path / "escape.jsonl")
        metrics.dump(path)
    finally:
        svc.stop()
    assert res["bad_results"] > 0, res
    out = _tool("soak_report.py", path)
    assert out.returncode == 1, out.stdout
    assert "escapes soak.bad_results" in out.stdout


def test_stop_racing_a_respawn_never_joins_an_unstarted_worker(shared_cache, monkeypatch):
    """A worker respawned (after a ``worker_death``) while ``stop()`` runs:
    the lane's thread is started before ``stop()`` can read it, so the
    join never meets an unstarted thread (the soak drill's
    ``stop(drain=True)`` under worker deaths)."""
    import threading

    svc = _service(shared_cache)
    real = threading.Thread
    starting = threading.Event()

    class SlowStart(real):
        def start(self):
            starting.set()
            time.sleep(0.2)
            super().start()

    monkeypatch.setattr(threading, "Thread", SlowStart)
    spawner = real(target=svc._spawn_worker, args=(svc._replicas[0],))
    spawner.start()
    assert starting.wait(5)
    monkeypatch.undo()
    try:
        svc.stop()  # must not raise "cannot join thread before it is started"
    finally:
        spawner.join(5)
        svc.stop()
    assert not spawner.is_alive()


def test_cuda_linalg_loads_once_before_the_lanes_start(monkeypatch):
    """torch's lazy CUDA linalg loader fails when two lanes make their
    first linalg call at once: the service makes that call once a process,
    before its workers start, and never for CPU lanes."""
    import threading

    calls = []
    monkeypatch.setattr(serve_service, "_linalg_loaded", False)
    monkeypatch.setattr(serve_service.torch, "ones", lambda *a, **k: ("ones", k.get("device")))
    monkeypatch.setattr(serve_service.torch.linalg, "cholesky_ex", calls.append)
    serve_service._load_cuda_linalg([torch.device("cpu")] * 2)
    assert calls == [] and not serve_service._linalg_loaded
    cuda = [torch.device("cuda", 0)] * 2
    ts = [threading.Thread(target=serve_service._load_cuda_linalg, args=(cuda,))
          for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    serve_service._load_cuda_linalg(cuda)
    assert calls == [("ones", torch.device("cuda", 0))] and serve_service._linalg_loaded


@pytest.mark.parametrize("n", [12, 300])
def test_residual_check_float64_decisions_match_jax(n):
    """float64 keeps the JAX package's 1e-6: the same verdicts on a correct
    X, on X off by relative 1e-7 .. 1e-4 and on the sdc_solve corruption."""
    rng = np.random.default_rng(n)
    for routine in ("gesv", "posv"):
        row = replay.gen_repeated_a(1, seed=n, n=n, routine=routine)[0]
        A, B = replay.materialize(row)
        X = np.linalg.solve(A, B)
        bad = X.copy()
        bad.flat[0] = bad.flat[0] * 2 + 1
        for Y in [X, bad] + [X * (1 + d * rng.standard_normal(X.shape))
                             for d in (1e-7, 1e-6, 1e-5, 1e-4)]:
            assert replay._residual_ok(routine, A, B, Y) == jreplay._residual_ok(routine, A, B, Y)
        assert replay._residual_ok(routine, A, B, X) and not replay._residual_ok(routine, A, B, bad)


def test_residual_check_float32_tolerance():
    """float32 keeps the JAX package's 1e-6, read in float64: a residual
    of 5e-7 of the scale passes, 2e-6 and the sdc_solve corruption fail,
    and the verdict and the reading are those of the same operands cast
    to float64 (the client's own product adds no float32 rounding)."""
    row = dict(replay.gen_repeated_a(1, seed=3, n=64)[0], dtype="float32")
    A, B = replay.materialize(row)
    X = np.linalg.solve(A, B)
    scale = np.abs(A).max() * np.abs(X).max() + np.abs(B).max()
    wide = lambda *v: [np.asarray(x, dtype=np.float64) for x in v]  # noqa: E731
    for rel, ok in ((5e-7, True), (2e-6, False)):
        Bp = (B.astype(np.float64) + rel * scale * np.sign(B)).astype(np.float32)
        assert bool(replay._residual_ok("gesv", A, Bp, X)) == ok
        assert replay._residual("gesv", A, Bp, X) == replay._residual("gesv", *wide(A, Bp, X))
        assert replay._residual_ok("gesv", *wide(A, Bp, X)) == ok
    bad = X.copy()
    bad.flat[0] = bad.flat[0] * 2 + 1
    assert not replay._residual_ok("gesv", A, B, bad)
    assert replay._residual("gesv", A, B, bad) > 1e-3


def test_recorder_records_a_hedged_pair_once_at_its_first_resolution():
    """A straggler's twin shares its future: whichever member resolves
    first is recorded, the loser is not, and a request that resolved
    before attach() is not recorded when its loser finishes after it."""
    from slate_tpu_torch.serve.service import _HedgeGroup

    A = np.eye(3)
    primary = _Request(routine="gesv", key=None, A=A, B=A[:, :1], m=3, n=3, nrhs=1,
                       deadline=time.monotonic() + 5.0, tenant="gold")
    grp = _HedgeGroup()
    primary.hedge_group = grp
    twin = _Request(routine="gesv", key=None, A=A, B=A[:, :1], m=3, n=3, nrhs=1,
                    future=primary.future, deadline=primary.deadline, tenant="gold",
                    is_hedge=True, hedge_group=grp)
    twin.t_submit = primary.t_submit
    rec = record.Recorder()
    rec._tap(twin, "ok")  # the twin wins: taps fire before the future is set
    primary.future.set_result(A[:, :1])
    rec._tap(primary, "ok")  # the loser finishes later
    [row] = rec.rows()
    assert row["deadline_s"] == pytest.approx(5.0, abs=1e-3) and row["tenant"] == "gold"
    late = record.Recorder()
    late._tap(primary, "ok")  # resolved before this recorder attached
    assert len(late) == 0


def _drill_service(shared_cache):
    """The service of the soak drill's leg (a) on the CPU (two lanes, every
    plane armed), its buckets warm."""
    for rt, n in (("gesv", 12), ("posv", 12), ("gesv", 24)):
        _ensure(shared_cache, rt, n)
    svc = _service(shared_cache, replicas=2, retry_backoff_s=0.002, breaker_cooldown_s=0.02,
                   factor_cache=FactorCache(max_entries=64), tenants=TENANTS, adaptive=True,
                   latency_budget_s=0.5,
                   integrity=ipol.parse_spec("full,hedge=1.5,cooldown=0.25"))
    svc.warmup()
    return svc


def _rt_spec():
    """The drill's round-trip mix (gen_multitenant seed 11, gen_repeated_a
    seed 12, distinct 5) at n = 12 / 24, cut to 120 rows at a CPU pace."""
    return replay.merge_specs(replay.gen_multitenant(70, seed=11, rate_rps=700),
                              replay.gen_repeated_a(50, seed=12, rate_rps=600, distinct=5))


def test_round_trip_passes_start_from_one_state(shared_cache):
    """Phase 20 (a)'s round trip (chip_smoke.py ``_round_trip20``) missed
    the gate's max(5, 5 %) on the gold tenant on a slow host.  Its two
    causes, reproduced here at the drill's n = 12 / 24:

    1. the faulted main leg leaves the overload plane raised: at level 2
       a gold request of ``normal`` priority (every gen_repeated_a row)
       is shed, so a pass that starts there refuses what a settled pass
       admits; ``_settle20`` brings the plane to level 0 and its burn
       EWMA to ~0 through ``tick`` and ``observe_burn``;
    2. the recorded rows draw new matrix bytes, so a replay of them
       misses the factor cache once a pool matrix where the recording
       (pool-warm) hit: replay 1 alone pays the misses, and on the card
       its p99 was 6-7 x the other passes'.  ``_round_trip20`` now warms
       the recording's pools before replay 1.

    With both, every pass starts at level 0, hits only, and refuses
    nothing; the mixes agree."""
    import chip_smoke as cs

    svc = _drill_service(shared_cache)
    try:
        spec, cache = _rt_spec(), {}
        replay.replay(svc, replay.warm_spec(spec), seed=0, cache=cache)
        adm = svc._admission
        for _ in range(8):  # the burn a faulted main leg leaves behind
            adm.observe_burn(3.0, time.monotonic())
        assert adm.snapshot()["overload_level"] == 2
        gold = next(r for r in spec if r["priority"] == "normal")
        A, B = replay.materialize(gold, seed=0, cache=cache)
        with pytest.raises(serve_service.Shed):
            svc.submit("gesv", A, B, tenant="gold", priority="normal")
        cs._settle20(svc)
        snap = adm.snapshot()
        assert snap["overload_level"] == 0 and snap["burn_ewma"] <= 1e-3
        svc.submit("gesv", A, B, tenant="gold", priority="normal").result(timeout=60)
        for _ in range(8):  # raised again: the round trip settles it itself
            adm.observe_burn(3.0, time.monotonic())
        out = cs._round_trip20(record, replay, svc, spec, 1.0, cache)
        assert set(out["passes"]) == {"recording", "replay 1", "replay 2"}
        for what, p in out["passes"].items():
            assert p["start"]["overload_level"] == 0, (what, p)
            assert p["factor_cache"]["miss"] == 0, (what, p)
            assert p["refused"]["reasons"] == {"shed": 0, "share": 0, "quota": 0,
                                               "queue_full": 0}, (what, p)
        assert out["mix_in"] == out["mix_out"]
        assert out["recording"]["refused"] == 0 and out["recorded"] == len(spec)
    finally:
        svc.stop()


def test_unwarmed_replay_of_a_recording_misses_once_a_pool(shared_cache):
    """The recorded rows' matrices are new bytes (their seeds derive from
    the recording's fingerprints): replaying a recording on the factors
    that served it misses once for every repeat group."""
    svc = _drill_service(shared_cache)
    try:
        spec, cache = _rt_spec(), {}
        replay.replay(svc, replay.warm_spec(spec), seed=0, cache=cache)
        c0 = metrics.counters()
        with record.Recorder() as rec:
            replay.replay(svc, spec, seed=0, cache=cache)
        recorded = rec.rows()
        c1 = metrics.counters()
        assert c1.get("serve.factor_cache.miss", 0) == c0.get("serve.factor_cache.miss", 0)
        groups = {r["repeat_fp"] for r in recorded}
        assert not groups & {r["repeat_fp"] for r in spec}  # new fingerprints
        replay.replay(svc, [dict(r, t_offset=i * 0.01) for i, r in enumerate(recorded)],
                      seed=0, cache=cache)
        misses = metrics.counters().get("serve.factor_cache.miss", 0) - c1.get(
            "serve.factor_cache.miss", 0)
        assert misses >= len(groups)
    finally:
        svc.stop()
