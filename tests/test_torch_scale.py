"""The port's elastic capacity plane on the CPU (ROADMAP.md Queue 1 item
7c2b): every case of tests/test_scale.py on ``slate_tpu_torch.scale`` and
the port's service, then parity with the JAX package: ``parse_spec`` and
``ScalePolicy`` (results and exception types), the aggregator's
snapshots, the controller's decision streams, ``plan_from_trace`` (and
plans loaded across the packages), ``GATE_GAUGES`` and the keys of
``health()["capacity"]``; the threshold edge both packages share; the
aux routine ``stt.scale`` in both import orders; the plane off (never
imported, routing as the JAX package's); the affinity spill against the
JAX package's; and a live service whose ``AutoScaler.step(now=...)`` runs
on the test's own clock, judged by ``tools/capacity_report.py``.

Lifecycle cases place their lanes on distinct CPU device ids (``cpu``,
``cpu:1``, ``cpu:2``): a core's first run on a device is its cold build,
so a new lane's prime is a real, counted one (on one card every lane is
``cuda:0`` and a prime is always skipped)."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from slate_tpu.aux import metrics as jmetrics
from slate_tpu.scale import controller as jctl
from slate_tpu.scale import gate as jgate
from slate_tpu.scale import signals as jsig
from slate_tpu.scale import warmup_plan as jwp
from slate_tpu.serve.cache import ExecutableCache as JExecutableCache
from slate_tpu.serve.factor_cache import FactorCache as JFactorCache
from slate_tpu.serve.service import SolverService as JSolverService
from slate_tpu_torch.aux import faults, metrics
from slate_tpu_torch.scale import controller as ctl
from slate_tpu_torch.scale import gate
from slate_tpu_torch.scale import signals as sig
from slate_tpu_torch.scale import warmup_plan as wp
from slate_tpu_torch.serve import buckets as bk
from slate_tpu_torch.serve.cache import ExecutableCache
from slate_tpu_torch.serve.factor_cache import FactorCache
from slate_tpu_torch.serve.placement import PlacementPolicy
from slate_tpu_torch.serve.service import SolverService
from slate_tpu_torch.soak import record, replay

torch.set_num_threads(1)

FLOOR = 16
NRHS_FLOOR = 4
DEVICES = ["cpu", "cpu:1", "cpu:2"]
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPORT = os.path.join(_REPO, "tools", "capacity_report.py")
#: the JAX gate's policy (run_tests.py _SCALE_DRIVER), stepped by hand:
#: the sampling thread's period is an hour, so only step() acts
POLICY = ("min=1,max=3,up=1.0,down=0.2,up_cooldown=0.25,down_cooldown=2.0,"
          "step=2,period=3600")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.delenv(ctl.SCALE_ENV, raising=False)
    for m in (metrics, jmetrics):
        m.off()
        m.reset()
        m.on()
    faults.reset()
    yield
    faults.reset()
    for m in (metrics, jmetrics):
        m.off()
        m.reset()


@pytest.fixture(scope="module")
def shared_cache():
    return ExecutableCache(manifest_path=None)


def _service(shared_cache, replicas=1, **kw):
    cfg = dict(cache=shared_cache, batch_max=1, batch_window_s=0.0005, dim_floor=FLOOR,
               nrhs_floor=NRHS_FLOOR,
               placement=PlacementPolicy(replicas=replicas, devices=DEVICES),
               factor_cache=FactorCache(max_entries=64))
    cfg.update(kw)
    svc = SolverService(**cfg)
    k = bk.bucket_for("gesv", 12, 12, 2, np.float64, floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    svc.cache.ensure_manifest(k, (1,))
    svc.cache.ensure_manifest(k.solve_sibling(), (1,))
    svc.warmup()
    return svc


def _ops(rng, n=12, nrhs=2):
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    B = rng.standard_normal((n, nrhs))
    return A, B


def _report():
    """tools/capacity_report.py as a module (stdlib only)."""
    spec = importlib.util.spec_from_file_location("capacity_report_under_test", _REPORT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# SLATE_TPU_SCALE grammar + policy validation
# ---------------------------------------------------------------------------


def test_parse_spec_off_tokens():
    for spec in ("", "0", "off", "OFF", "false", "no"):
        assert ctl.parse_spec(spec) is None


def test_parse_spec_defaults_and_kv():
    assert ctl.parse_spec("on") == ctl.ScalePolicy()
    assert ctl.parse_spec("1") == ctl.ScalePolicy()
    p = ctl.parse_spec("min=2,max=6,up=1.5,down=0.1,step=3,period=0.5")
    assert (p.min_replicas, p.max_replicas) == (2, 6)
    assert (p.up_threshold, p.down_threshold) == (1.5, 0.1)
    assert (p.step_max, p.period_s) == (3, 0.5)


def test_parse_spec_rejects_unknown_keys():
    with pytest.raises(ValueError):
        ctl.parse_spec("replicas=3")
    with pytest.raises(ValueError):
        ctl.parse_spec("min")  # bare token, not k=v


def test_policy_validation():
    with pytest.raises(ValueError):
        ctl.ScalePolicy(min_replicas=0)
    with pytest.raises(ValueError):
        ctl.ScalePolicy(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError):
        ctl.ScalePolicy(up_threshold=0.5, down_threshold=0.5)


_SPECS = [
    "", "0", "off", "OFF", "false", "no", "on", "1", "yes", "TRUE",
    "min=2,max=6,up=1.5,down=0.1,step=3,period=0.5",
    " min = 1 , max = 3 ,, up_cooldown=0.25, down_cooldown=2 ",
    POLICY, "MIN=2,Max=4",
    # the bad ones: unknown key, bare token, unparsable value, each
    # validation rule
    "replicas=3", "min", "min=x", "up=fast", "min=0", "min=3,max=2", "up=0.5,down=0.5",
    "step=0", "min=2.5",
]


@pytest.mark.parametrize("spec", _SPECS)
def test_parse_spec_matches_jax(spec):
    """Equal policies, or the same exception type, from both packages."""
    def run(mod):
        try:
            p = mod.parse_spec(spec)
        except Exception as e:  # noqa: BLE001 -- the type is what is compared
            return ("raise", type(e))
        return ("ok", None if p is None else dataclasses.asdict(p))

    assert run(ctl) == run(jctl)


def test_policy_from_options_env_wins(monkeypatch):
    from slate_tpu_torch.enums import Option

    monkeypatch.setenv(ctl.SCALE_ENV, "min=1,max=2")
    assert ctl.policy_from_options({Option.ServeScale: "min=2,max=5"}).max_replicas == 2
    monkeypatch.delenv(ctl.SCALE_ENV)
    assert ctl.policy_from_options({Option.ServeScale: "min=2,max=5"}).max_replicas == 5
    assert ctl.policy_from_options() is None


# ---------------------------------------------------------------------------
# controller: hysteresis, cooldowns, AIMD, determinism
# ---------------------------------------------------------------------------


def _snap(t, pressure, replicas, mod=sig):
    return mod.PressureSnapshot(
        t=t, replicas=replicas, queue_depth=0, inflight=0, queue_per_replica=0.0,
        oldest_queued_s=0.0, burn_ewma=0.0, overload_level=0, request_rate=0.0,
        hedge_rate=0.0, pad_waste_rate=0.0, hbm_headroom_frac=None, pressure=pressure)


def test_controller_aimd_up_and_single_step_down():
    pol = ctl.ScalePolicy(min_replicas=1, max_replicas=8, up_cooldown_s=1.0,
                          down_cooldown_s=2.0, step_max=4)
    c = ctl.ScaleController(pol)
    d1 = c.decide(_snap(0.0, 2.0, 1))
    assert (d1.action, d1.delta) == (ctl.UP, 1)
    # inside the up cooldown: hold, whatever the pressure says
    assert c.decide(_snap(0.5, 3.0, 2)).action == ctl.HOLD
    # sustained saturation: the step doubles (1 -> 2 -> 4, capped)
    d2 = c.decide(_snap(1.1, 2.0, 2))
    assert (d2.action, d2.delta) == (ctl.UP, 2)
    d3 = c.decide(_snap(2.2, 2.0, 4))
    assert (d3.action, d3.delta) == (ctl.UP, 4)
    # scale-down is additive: one lane, after the longer cooldown
    assert c.decide(_snap(3.0, 0.0, 8)).action == ctl.HOLD
    d4 = c.decide(_snap(4.3, 0.0, 8))
    assert (d4.action, d4.delta) == (ctl.DOWN, 1)


def test_controller_bound_holds():
    c = ctl.ScaleController(ctl.ScalePolicy(min_replicas=1, max_replicas=2))
    assert c.decide(_snap(0.0, 5.0, 2)).reason == "at max_replicas"
    assert c.decide(_snap(1.0, 0.0, 1)).reason == "at min_replicas"
    assert c.decide(_snap(2.0, 0.5, 1)).reason == "in hysteresis band"


def _raw_stream():
    """A deterministic synthetic observation stream: quiet, a queue burst,
    quiet again -- plain dicts, exactly what read_raw returns."""
    rows = []
    reqs = 0.0
    for i in range(60):
        burst = 10 <= i < 30
        reqs += 4.0 if burst else 1.0
        rows.append({
            # the fleet grows mid-stream (as the actuator would have made
            # it): the quiet tail must produce scale-DOWNs
            "t": i * 0.05, "replicas": 2.0 if i >= 30 else 1.0,
            "queue_depth": 9.0 if burst else 0.0, "inflight": 1.0,
            "oldest_queued_s": 0.8 if burst else 0.0,
            "burn_ewma": 0.3 if burst else 0.0,
            "overload_level": 0.0, "requests": reqs, "hedges": 0.0, "pad_rows": 0.0,
            "hbm_headroom_frac": None,
        })
    return rows


def test_controller_seeded_determinism():
    def run():
        agg = sig.SignalAggregator()
        c = ctl.ScaleController(ctl.ScalePolicy(up_cooldown_s=0.3, down_cooldown_s=0.5))
        return [c.decide(agg.update(raw)) for raw in _raw_stream()]

    a, b = run(), run()
    # frozen dataclasses all the way down: == compares the full decision
    # record including the driving snapshot
    assert a == b
    assert any(d.action == ctl.UP for d in a)
    assert any(d.action == ctl.DOWN for d in a)


def test_no_flap_under_oscillating_pressure():
    """Pressure square-waves across both thresholds every sample; the
    cooldowns must keep the fleet from ping-ponging."""
    pol = ctl.ScalePolicy(min_replicas=1, max_replicas=3, up_cooldown_s=0.5,
                          down_cooldown_s=1.0)
    c = ctl.ScaleController(pol)
    n = 1
    changes = []
    for i in range(100):
        t = i * 0.05
        d = c.decide(_snap(t, 2.0 if i % 2 == 0 else 0.0, n))
        if d.action == ctl.UP:
            n += d.delta
            changes.append((t, d.action))
        elif d.action == ctl.DOWN:
            n -= d.delta
            changes.append((t, d.action))
        assert pol.min_replicas <= n <= pol.max_replicas
    # every applied change clears the cooldown of its direction from the
    # PREVIOUS change
    for (t0, _a0), (t1, a1) in zip(changes, changes[1:]):
        floor = pol.up_cooldown_s if a1 == ctl.UP else pol.down_cooldown_s
        assert t1 - t0 >= floor - 1e-9, changes
    assert len(changes) <= 8, changes


def test_aggregator_pure_fold_and_reset():
    agg = sig.SignalAggregator()
    snaps = [agg.update(r) for r in _raw_stream()]
    agg.reset()
    again = [agg.update(r) for r in _raw_stream()]
    assert snaps == again
    # the burst pushes the composite past 1.0 and it decays after
    assert max(s.pressure for s in snaps) > 1.0
    assert snaps[-1].pressure < 0.25
    # rates derive from counter deltas: quiet tail ~= 20 req/s
    assert snaps[-1].request_rate == pytest.approx(20.0, rel=0.5)


def _raw_stream_rich():
    """The stream above plus every other component: burn, overload levels,
    hedges, pad rows, a device headroom, a shrinking clock step and a
    counter reset (negative delta, clipped to 0)."""
    rows = []
    for i, r in enumerate(_raw_stream()):
        r = dict(r)
        r["burn_ewma"] = 0.1 * (i % 7)
        r["overload_level"] = float(i // 20)
        r["hedges"] = float(i // 3)
        r["pad_rows"] = float(5 * i if i < 40 else 0)
        r["hbm_headroom_frac"] = None if i % 2 else 1.0 - i / 100
        if i == 30:
            r["t"] = rows[-1]["t"]  # dt == 0: no rate update
        rows.append(r)
    return rows


@pytest.mark.parametrize("stream", [_raw_stream, _raw_stream_rich])
def test_aggregator_matches_jax(stream):
    """One raw stream gives equal snapshots in both packages."""
    a, b = sig.SignalAggregator(alpha=0.3), jsig.SignalAggregator(alpha=0.3)
    ours = [dataclasses.asdict(a.update(r)) for r in stream()]
    theirs = [dataclasses.asdict(b.update(r)) for r in stream()]
    assert ours == theirs
    assert max(s["pressure"] for s in ours) > 1.0
    with pytest.raises(ValueError):
        sig.SignalAggregator(alpha=0.0)


def _decisions(mod, sigmod, snaps, policy):
    c = mod.ScaleController(mod.ScalePolicy(**policy))
    return [(d.action, d.delta, d.reason)
            for d in (c.decide(sigmod.PressureSnapshot(**s)) for s in snaps)]


def _square_wave():
    return [dataclasses.asdict(_snap(i * 0.05, 2.0 if i % 2 == 0 else 0.0, 1 + i % 3))
            for i in range(100)]


def _aimd_stream():
    rows = [(0.0, 2.0, 1), (0.5, 3.0, 2), (1.1, 2.0, 2), (2.2, 2.0, 4), (3.0, 0.0, 8),
            (4.3, 0.0, 8), (4.4, 1.0, 7), (6.4, 0.25, 7), (6.5, 0.2, 7), (9.0, 0.1, 6)]
    return [dataclasses.asdict(_snap(*r)) for r in rows]


@pytest.mark.parametrize("case", ["aimd", "no_flap", "seeded"])
def test_controller_matches_jax(case):
    """One snapshot stream gives equal (action, delta, reason) streams."""
    if case == "aimd":
        snaps, pol = _aimd_stream(), dict(max_replicas=8, up_cooldown_s=1.0,
                                          down_cooldown_s=2.0, step_max=4)
    elif case == "no_flap":
        snaps, pol = _square_wave(), dict(max_replicas=3, up_cooldown_s=0.5,
                                          down_cooldown_s=1.0)
    else:
        agg = sig.SignalAggregator()
        snaps = [dataclasses.asdict(agg.update(r)) for r in _raw_stream_rich()]
        pol = dict(up_cooldown_s=0.3, down_cooldown_s=0.5)
    ours = _decisions(ctl, sig, snaps, pol)
    assert ours == _decisions(jctl, jsig, snaps, pol)
    assert {a for a, _d, _r in ours} >= {ctl.UP, ctl.HOLD}


@pytest.mark.parametrize("mod,sigmod", [(ctl, sig), (jctl, jsig)], ids=["port", "jax"])
def test_threshold_edge_scales_up_and_the_report_calls_it_undriven(mod, sigmod, tmp_path):
    """The reference's edge, pinned in both packages: overload level 1
    alone reads pressure exactly 1.0; the controller scales up at
    ``pressure >= up`` while tools/capacity_report.py calls an up
    undriven at ``pressure <= up``, so that decision fails the report.
    The drills run without adaptive admission, as the JAX gate does."""
    raw = {"t": 0.0, "replicas": 1.0, "queue_depth": 0.0, "inflight": 0.0,
           "oldest_queued_s": 0.0, "burn_ewma": 0.0, "overload_level": 1.0,
           "requests": 0.0, "hedges": 0.0, "pad_rows": 0.0, "hbm_headroom_frac": None}
    snap = sigmod.SignalAggregator().update(raw)
    assert snap.pressure == 1.0
    dec = mod.ScaleController(mod.ScalePolicy(up_threshold=1.0)).decide(snap)
    assert (dec.action, dec.delta) == (mod.UP, 1)
    path = tmp_path / "edge.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in (
        {"type": "gauge", "name": "scale.gate.up_threshold", "value": 1.0},
        {"type": "counter", "name": "scale.up", "value": 1},
        {"type": "timeline", "kind": "scale", "t_mono": 0.0, "action": "up", "delta": 1,
         "reason": dec.reason, "pressure": snap.pressure, "replicas": 1},
    )) + "\n")
    rows = {r["check"]: r["ok"] for r in _report().analyze(str(path))["rows"]}
    assert rows["scale-ups driven by signal"] is False


# ---------------------------------------------------------------------------
# predictive warmup planning
# ---------------------------------------------------------------------------


def _trace_rows():
    rows = []
    # hot small bucket: 3 repeat groups x 20 rows, bursty arrivals
    for g in range(3):
        for i in range(20):
            rows.append({
                "t_offset": g * 1.0 + (i // 4) * 0.1 + (i % 4) * 1e-4,
                "routine": "gesv", "bucket_shape": [12, 12, 2], "dtype": "float64",
                "repeat_fp": f"hot-{g}", "matrix_seed": g, "rhs_seed": i,
            })
    # rare large bucket: 4 singleton rows (no repeats, no bursts)
    for i in range(4):
        rows.append({
            "t_offset": 10.0 + i, "routine": "gesv", "bucket_shape": [48, 48, 2],
            "dtype": "float64", "repeat_fp": None, "matrix_seed": 100 + i, "rhs_seed": i,
        })
    return rows


def test_plan_ranking_traffic_times_cost():
    plan = wp.plan_from_trace(_trace_rows(), batch_max=4, batch_window_s=0.005,
                              dim_floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    assert plan.total_rows == 64
    scores = [e.score for e in plan.entries]
    assert scores == sorted(scores, reverse=True)
    labels = {(e.key.label, e.key.phase, e.batch) for e in plan.entries}
    # the bursty hot bucket plans its coalesced batch point too
    hot = [e for e in plan.entries if e.key.n == 16 and e.key.phase == "full"]
    assert {e.batch for e in hot} == {1, 4}
    # repeat groups dispatch the solve sibling on a warm factor cache
    assert any(ph == "solve" for (_l, ph, _b) in labels)
    # the rare-but-huge bucket outranks the hot-but-tiny one:
    # 4/64 x flops(64) beats 60/64 x flops(16)
    big = next(e for e in plan.entries if e.key.n == 64)
    small_b1 = next(e for e in hot if e.batch == 1)
    assert big.score > small_b1.score


def test_plan_preload_ranks_by_bought_hits():
    plan = wp.plan_from_trace(_trace_rows(), dim_floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    assert [p.repeat_fp for p in plan.preload] == ["hot-0", "hot-1", "hot-2"]
    assert all(p.rows == 20 for p in plan.preload)
    # singletons buy no hits: never preloaded
    assert all(p.repeat_fp.startswith("hot-") for p in plan.preload)


def test_plan_save_load_round_trip(tmp_path):
    plan = wp.plan_from_trace(_trace_rows(), dim_floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    path = plan.save(str(tmp_path / "plan.jsonl"))
    back = wp.WarmupPlan.load(path)
    assert back.total_rows == plan.total_rows
    assert back.entries == plan.entries
    assert back.preload == plan.preload
    assert back.pairs(2) == plan.pairs(2)


def test_plan_from_generated_burst_trace():
    rows = replay.gen_burst(200, seed=3, base_rps=50, burst_rps=500, burst_start_s=0.5,
                            burst_len_s=0.5)
    plan = wp.plan_from_trace(rows, batch_max=8, dim_floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    assert plan.total_rows == 200
    assert plan.entries and plan.preload
    # the burst coalesces: some batch point above 1 is planned
    assert max(e.batch for e in plan.entries) > 1


def test_gen_burst_shape():
    rows = replay.gen_burst(400, seed=1, base_rps=30, burst_rps=300, burst_start_s=1.0,
                            burst_len_s=1.0)
    in_burst = [r for r in rows if 1.0 <= r["t_offset"] < 2.0]
    before = [r for r in rows if r["t_offset"] < 1.0]
    # ~30 arrivals in the first second, ~300 in the burst second
    assert len(before) < len(in_burst) / 3
    assert rows == sorted(rows, key=lambda r: r["t_offset"])


def _plan_json(plan):
    return ([e.to_json() for e in plan.entries], [p.to_json() for p in plan.preload],
            plan.total_rows)


class _CostCache:
    """A cache stand-in with captured rows for some keys (both packages'
    ``_compile_cost`` call ``cache.cost(key, batch)``)."""

    def cost(self, key, batch):
        if key.phase == "solve":
            return {"flops": 1234.5, "flops_model": 99.0}
        return {"flops_model": 7.0} if batch > 1 else None


@pytest.mark.parametrize("trace", ["hand", "burst", "burst_costed", "recorded"])
def test_plan_from_trace_matches_jax(trace, tmp_path):
    """Equal plans from the same rows, and plans that load in the other
    package (both directions)."""
    cache = None
    kw = dict(dim_floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    if trace == "hand":
        rows = _trace_rows()
        kw.update(batch_max=4, batch_window_s=0.005)
    else:
        rows = replay.gen_burst(300, seed=9, base_rps=30, burst_rps=600, burst_start_s=0.2,
                                burst_len_s=0.3, n=40, distinct=5)
        kw.update(batch_max=8)
        if trace == "burst_costed":
            cache = _CostCache()
        elif trace == "recorded":
            path = record.save(rows, str(tmp_path / "spec.jsonl"), source="gen_burst")
            rows = record.load(path)
    ours = wp.plan_from_trace(rows, cache=cache, **kw)
    theirs = jwp.plan_from_trace(rows, cache=cache, **kw)
    assert _plan_json(ours) == _plan_json(theirs)
    assert ours.entries and ours.preload
    a = ours.save(str(tmp_path / "port.jsonl"))
    b = theirs.save(str(tmp_path / "jax.jsonl"))
    assert open(a).read() == open(b).read()
    assert _plan_json(jwp.WarmupPlan.load(a)) == _plan_json(ours)
    assert _plan_json(wp.WarmupPlan.load(b)) == _plan_json(theirs)
    assert [(k.label, n) for k, n in wp.WarmupPlan.load(b).pairs(3)] == [
        (k.label, n) for k, n in ours.pairs(3)]


def test_plan_load_refuses_a_newer_version(tmp_path):
    path = tmp_path / "future.jsonl"
    path.write_text(json.dumps({"type": "plan_meta", "version": wp.PLAN_VERSION + 1}) + "\n")
    with pytest.raises(ValueError):
        wp.WarmupPlan.load(str(path))


def test_gate_gauges_match_jax():
    assert gate.GATE_GAUGES == jgate.GATE_GAUGES
    names = [g[len("scale.gate."):] for g in gate.GATE_GAUGES]
    with pytest.raises(KeyError):
        gate.publish({n: 0.0 for n in names[1:]})
    with pytest.raises(KeyError):
        gate.publish({**{n: 0.0 for n in names}, "typo_s": 1.0})
    gate.publish({n: float(i) for i, n in enumerate(names)})
    assert {k: v for k, v in metrics.gauges().items() if k.startswith("scale.gate.")} == {
        g: float(i) for i, g in enumerate(gate.GATE_GAUGES)}


# ---------------------------------------------------------------------------
# zero-overhead-off + env arming + callable-module compatibility
# ---------------------------------------------------------------------------


def test_scaler_off_by_default(shared_cache):
    svc = _service(shared_cache)
    try:
        assert svc._scaler is None
        h = svc.health()
        assert h["capacity"] is None
        assert all(lane["state"] == "live" for lane in h["replicas"])
    finally:
        svc.stop()


def test_env_arms_scaler(shared_cache, monkeypatch):
    monkeypatch.setenv(ctl.SCALE_ENV, "min=1,max=2,period=30")
    svc = _service(shared_cache)
    try:
        assert svc._scaler is not None
        assert svc._scaler.policy.max_replicas == 2
        dec = svc._scaler.step()  # idle fleet at min: hold
        assert dec.action == ctl.HOLD
        cap = svc.health()["capacity"]
        assert cap["policy"]["max_replicas"] == 2
        assert cap["last_action"] == ctl.HOLD
        assert cap["running"] is True and cap["terminal_lanes"] == []
        assert metrics.counters().get("scale.decisions") == 1
    finally:
        svc.stop()
    assert svc._scaler._thread is None  # stop() stops the sampler


def test_capacity_keys_match_jax(shared_cache, monkeypatch):
    monkeypatch.setenv(ctl.SCALE_ENV, "min=1,max=2,period=30")
    svc = _service(shared_cache)
    jsvc = JSolverService(cache=JExecutableCache(manifest_path=None), batch_max=1,
                          dim_floor=FLOOR, nrhs_floor=NRHS_FLOOR, replicas=1)
    try:
        for s in (svc, jsvc):
            s._scaler.step()
        cap, jcap = svc.health()["capacity"], jsvc.health()["capacity"]
        assert set(cap) == set(jcap)
        assert cap["policy"] == jcap["policy"]
        assert {k: cap[k] for k in ("decisions", "last_action", "last_reason", "replicas")} == {
            k: jcap[k] for k in ("decisions", "last_action", "last_reason", "replicas")}
    finally:
        svc.stop()
        jsvc.stop()


def test_scale_module_still_callable_as_aux_driver():
    # slate_tpu_torch.scale is also the aux scaling routine; importing the
    # package must not break its callers
    import slate_tpu_torch as stt
    import slate_tpu_torch.scale as scale_pkg

    assert scale_pkg.ScalePolicy is ctl.ScalePolicy
    A0 = np.arange(16.0).reshape(4, 4)
    cpu = stt.ProcessGrid.single("cpu")
    A2 = stt.scale(3.0, 2.0, stt.Matrix.from_global(A0.copy(), 4, grid=cpu))
    np.testing.assert_allclose(A2.to_global().numpy(), A0 * 1.5)


_IMPORT_ORDER = """
import sys
import numpy as np
order = sys.argv[1]
if order == "package_first":
    import slate_tpu_torch.scale as pkg
    import slate_tpu_torch as stt
    assert stt.scale is pkg, stt.scale
else:
    import slate_tpu_torch as stt
    from slate_tpu_torch import scale as routine
    A0 = np.arange(16.0).reshape(4, 4)
    cpu = stt.ProcessGrid.single("cpu")
    before = routine(3.0, 2.0, stt.Matrix.from_global(A0.copy(), 4, grid=cpu))
    assert np.allclose(before.to_global().numpy(), A0 * 1.5)
    import slate_tpu_torch.scale as pkg
    assert stt.scale is pkg and routine is not pkg
A0 = np.arange(16.0).reshape(4, 4)
cpu = stt.ProcessGrid.single("cpu")
A2 = stt.scale(3.0, 2.0, stt.Matrix.from_global(A0.copy(), 4, grid=cpu))
assert np.allclose(A2.to_global().numpy(), A0 * 1.5)
assert stt.scale.ScalePolicy is pkg.controller.ScalePolicy
print("ok")
"""


@pytest.mark.parametrize("order", ["package_first", "routine_first"])
def test_stt_scale_callable_in_both_import_orders(order):
    out = subprocess.run([sys.executable, "-c", _IMPORT_ORDER, order], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


_OFF_PROBE = """
import os, sys
import numpy as np
from slate_tpu_torch.serve.placement import PlacementPolicy
from slate_tpu_torch.serve.service import SolverService
os.environ.pop("SLATE_TPU_SCALE", None)
kw = dict(placement=PlacementPolicy(devices=["cpu"]), dim_floor=16, nrhs_floor=4)
svc = SolverService(**kw)
A = np.eye(12) * 3.0
X = svc.submit("gesv", A, np.ones((12, 2))).result(60)
assert np.allclose(A @ X, 1.0)
assert svc._scaler is None and svc.health()["capacity"] is None
svc.stop()
off = "slate_tpu_torch.scale" in sys.modules
os.environ["SLATE_TPU_SCALE"] = "min=1,max=2,period=60"
svc = SolverService(**kw)
on = "slate_tpu_torch.scale" in sys.modules and svc.health()["capacity"] is not None
svc.stop()
print(off, on)
"""


def test_scaler_off_never_imports_the_scale_package():
    out = subprocess.run([sys.executable, "-c", _OFF_PROBE], cwd=_REPO, capture_output=True,
                         text=True, timeout=120,
                         env={k: v for k, v in os.environ.items() if k != "SLATE_TPU_SCALE"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["False", "True"]


# ---------------------------------------------------------------------------
# live lifecycle: add / remove / drain / re-home
# ---------------------------------------------------------------------------


def test_add_replica_then_steady_state_compile_free(shared_cache):
    svc = _service(shared_cache)
    rng = np.random.default_rng(0)
    try:
        A, B = _ops(rng)
        for f in [svc.submit("gesv", A, B) for _ in range(8)]:
            f.result(30)
        name = svc.add_replica()
        with svc._cond:
            assert len(svc._replicas) == 2
            assert svc._replicas[1].device == torch.device("cpu", 1)
        # the new lane was primed inside add_replica: steady-state traffic
        # afterwards makes no cold build
        with metrics.deltas() as d:
            futs = [svc.submit("gesv", A, B) for _ in range(16)]
            for f in futs:
                f.result(30)
            assert d.get("jit.compilations") == 0
        h = svc.health()
        states = {lane["name"]: lane["state"] for lane in h["replicas"]}
        assert states[name] == "live"
        assert metrics.counters().get("scale.replicas_added") == 1
    finally:
        svc.stop()


def test_remove_replica_drains_and_rehomes(shared_cache):
    svc = _service(shared_cache, replicas=2)
    rng = np.random.default_rng(1)
    try:
        # distinct matrices fill the factor cache with entries homed on
        # both lanes
        ops = [_ops(rng) for _ in range(24)]
        for f in [svc.submit("gesv", A, B) for A, B in ops]:
            f.result(30)
        pre = sum(1 for e in svc.factor_cache._entries.values() if e.replica == "1")
        # repeat traffic (factor hits) in flight while lane 1 drains
        futs = [svc.submit("gesv", A, B) for A, B in ops]
        removed = svc.remove_replica("1", drain_timeout=60)
        assert removed == "1"
        for f in futs:  # every inflight/queued future still resolves
            np.asarray(f.result(60))
        with svc._cond:
            assert len(svc._replicas) == 1
        # no factor entry left homed on the dead lane
        assert not any(e.replica == "1" for e in svc.factor_cache._entries.values())
        c = metrics.counters()
        if pre:
            assert c.get("scale.factors_rehomed", 0) >= pre
            assert c.get("serve.factor_cache.rehome", 0) >= pre
        assert c.get("serve.replica.1.removed") == 1
        # the lane stays visible as a terminal row, not a vanished one
        h = svc.health()
        states = {lane["name"]: lane["state"] for lane in h["replicas"]}
        assert states["1"] == "removed"
        row = next(lane for lane in h["replicas"] if lane["name"] == "1")
        assert row["worker_alive"] is False
        # and the survivor still serves
        A, B = ops[0]
        np.asarray(svc.submit("gesv", A, B).result(30))
    finally:
        svc.stop()


def test_remove_last_lane_refused(shared_cache):
    svc = _service(shared_cache)
    try:
        with pytest.raises(ValueError):
            svc.remove_replica()
        with pytest.raises(ValueError):
            svc.remove_replica("no-such-lane")
    finally:
        svc.stop()


def test_add_replica_after_stop_refused(shared_cache):
    svc = _service(shared_cache)
    svc.stop()
    with pytest.raises(RuntimeError):
        svc.add_replica()


def test_add_replica_with_plan(shared_cache):
    """A recorded-trace plan drives the new lane's priming order."""
    svc = _service(shared_cache)
    rng = np.random.default_rng(2)
    try:
        rows = [{"t_offset": i * 0.001, "routine": "gesv", "bucket_shape": [12, 12, 2],
                 "dtype": "float64", "repeat_fp": "p0", "matrix_seed": 0, "rhs_seed": i}
                for i in range(10)]
        plan = wp.plan_from_trace(rows, batch_max=1, dim_floor=FLOOR, nrhs_floor=NRHS_FLOOR)
        name = svc.add_replica(plan=plan)
        c = metrics.counters()
        primed = sum(v for k, v in c.items() if k.startswith("scale.prime_"))
        assert primed >= 1
        A, B = _ops(rng)
        np.asarray(svc.submit("gesv", A, B).result(30))
        with svc._cond:
            assert [r.name for r in svc._replicas] == ["0", name]
    finally:
        svc.stop()


def test_read_raw_live_service(shared_cache):
    svc = _service(shared_cache, replicas=2)
    try:
        raw = sig.read_raw(svc)
        assert raw["replicas"] == 2.0
        assert raw["queue_depth"] >= 0.0
        assert raw["hbm_headroom_frac"] is None  # CPU lanes report no memory
        snap = sig.SignalAggregator().update(raw)
        assert snap.replicas == 2
        assert snap.pressure >= 0.0
    finally:
        svc.stop()


def test_prime_plan_order_registers_and_counts_device_primes(tmp_path):
    """``prime(entries=...)``: the caller's order, unseen entries
    registered in the manifest first, batch points past batch_max and
    mesh entries skipped, a live entry's new device a counted prime, and
    a failure counted, never raised."""
    cache = ExecutableCache(manifest_path=str(tmp_path / "m.json"))
    k12 = bk.bucket_for("gesv", 12, 12, 2, np.float64, floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    k40 = bk.bucket_for("posv", 40, 40, 2, np.float64, floor=FLOOR, nrhs_floor=NRHS_FLOOR)
    mesh = dataclasses.replace(k12, mesh="2x2")
    got = cache.prime([(k40, 1), (k12, 1), (k12, 8), (mesh, 1)], devices=["cpu"],
                      batch_max=4, tag="scale_warm")
    assert got == {"entries": 2, "restored": 0, "compiled": 2, "failed": 0, "skipped": 0}
    assert cache.entries() == sorted([(k40, 1), (k12, 1)], key=lambda e: (e[0].label, e[1]))
    assert json.load(open(tmp_path / "m.json"))
    assert metrics.counters().get("serve.mesh_unfit_skipped") == 1
    with metrics.deltas() as d:
        again = cache.prime([(k12, 1)], devices=["cpu", "cpu:1"])
        assert again["skipped"] == 1 and d.get("serve.device_primes") == 1
        assert d.get("jit.compilations") == 1
    faults.configure("execute:every=1")
    faults.on()
    bad = cache.prime([(k40, 1)], devices=["cpu:2"])
    faults.reset()
    assert bad["failed"] == 1 and metrics.counters().get("serve.prime_failed") == 1


# ---------------------------------------------------------------------------
# the elastic affinity spill: armed only with the scaler
# ---------------------------------------------------------------------------


def _spill_run(pkg, armed, monkeypatch, dispatch=False):
    """One repeat-A stream against a paused two-lane service whose factor
    cache already holds A's factor on lane "0": every request is a hit
    owned by lane 0, and nothing dispatches, so lane 0 drowns.  Returns
    the per-lane queue lengths and the routing counters; with
    ``dispatch`` the service then starts, and the largest residual of the
    delivered X and the counters after delivery come too."""
    if armed:
        monkeypatch.setenv(ctl.SCALE_ENV, "min=1,max=3,period=3600")
    else:
        monkeypatch.delenv(ctl.SCALE_ENV, raising=False)
    rng = np.random.default_rng(5)
    A, B = _ops(rng)
    if pkg == "port":
        fc = FactorCache(max_entries=16)
        kw = dict(cache=ExecutableCache(manifest_path=None), factor_cache=fc, batch_max=1,
                  dim_floor=FLOOR, nrhs_floor=NRHS_FLOOR)
        warm = SolverService(placement=PlacementPolicy(devices=["cpu"]), **kw)
        paused = dict(placement=PlacementPolicy(replicas=2, devices=DEVICES[:2]), **kw)
        mod, make = metrics, SolverService
    else:
        fc = JFactorCache(max_entries=16)
        kw = dict(cache=JExecutableCache(manifest_path=None), factor_cache=fc, batch_max=1,
                  dim_floor=FLOOR, nrhs_floor=NRHS_FLOOR)
        warm = JSolverService(replicas=1, **kw)
        paused = dict(replicas=2, **kw)
        mod, make = jmetrics, JSolverService
    try:
        warm.submit("gesv", A, B).result(120)  # the miss: lane "0" owns A's factor
        warm.warmup()  # the solve bucket the hits dispatch
    finally:
        warm.stop()
    mod.reset()

    def routing():
        return {k: v for k, v in mod.counters().items()
                if k.startswith(("serve.factor_cache", "scale.", "serve.requests"))
                and not k.startswith("serve.factor_cache.bytes")}

    svc = make(start=False, **paused)
    assert (svc._scaler is not None) == armed
    Bs = [rng.standard_normal(B.shape) for _ in range(24)]
    try:
        futs = [svc.submit("gesv", A, b) for b in Bs]
        with svc._cond:
            depths = [len(r.q) for r in svc._replicas]
        routed = routing()
        if not dispatch:
            return depths, routed
        svc.start()
        worst = max(np.abs(A @ f.result(60) - b).max() for f, b in zip(futs, Bs))
        return depths, routed, worst, routing()
    finally:
        svc.stop()


@pytest.mark.parametrize("armed", [False, True], ids=["off", "armed"])
def test_affinity_spill_only_with_the_scaler(armed, monkeypatch):
    ours = _spill_run("port", armed, monkeypatch)
    theirs = _spill_run("jax", armed, monkeypatch)
    assert ours == theirs
    depths, counters = ours
    if armed:
        # own_load > 2 batch_max and >= 4 (alt_load + 1): lane 0 keeps
        # most, the spills go to lane 1
        assert counters["scale.affinity_spills"] == depths[1] >= 2
        assert counters["serve.factor_cache.spill"] == depths[1]
    else:
        assert depths == [24, 0]
        assert "scale.affinity_spills" not in counters
        assert "serve.factor_cache.spill" not in counters


def test_spilled_requests_solve_from_the_cached_factor(monkeypatch):
    """A spilled request takes the selected lane's direct factor path,
    which finds the cached factor and solves from it: every one of the 24
    is a counted hit with a right X, none refactors, and the factor stays
    homed on its owner."""
    depths, _routed, worst, after = _spill_run("port", True, monkeypatch, dispatch=True)
    assert depths[1] >= 2 and worst <= 1e-12
    assert after["serve.factor_cache.hit"] == 24
    assert after["scale.affinity_spills"] == depths[1]
    assert not any(k.endswith((".miss", ".refactor")) for k in after), after


# ---------------------------------------------------------------------------
# a live service stepped on the test's own clock, judged by the report
# ---------------------------------------------------------------------------

TAX_MS = 50  # the latency tax a dispatch: one lane serves <= 20 requests/s
BURST = 24  # requests of the burst
FIRST = 8  # of them, queued before the first control step
BUDGET_S = 1.0


def _burst(svc, ops, lat):
    """Submit ``ops`` at once; each latency lands in ``lat`` at resolution."""
    futs = []
    for A, B in ops:
        t0 = time.monotonic()
        f = svc.submit("gesv", A, B)
        f.add_done_callback(lambda _f, t0=t0: lat.append(time.monotonic() - t0))
        futs.append(f)
    return futs


def _p99(lat):
    lat = sorted(lat)
    return lat[min(len(lat) - 1, int(0.99 * len(lat)))]


def _capacity_drill(tmp_path, monkeypatch):
    """The JAX gate's two legs on one burst, the scaler stepped by hand.

    Static: one lane, the burst of 24 under a 50 ms tax (the last request
    waits >= 24 x 50 ms, so the 1 s budget is missed by construction).
    Elastic: 8 requests queue on lane 0, two control steps scale up to 3
    (the smoothed depth keeps the second step above threshold whatever
    lane 0 drained meanwhile), the other 16 spread over the new lanes;
    then the drained service is stepped on in virtual time until the
    fleet is back at 1.  Returns the dump path and the books."""
    rng = np.random.default_rng(7)
    ops = [_ops(rng) for _ in range(BURST)]
    k = bk.bucket_for("gesv", 12, 12, 2, np.float64, floor=FLOOR, nrhs_floor=NRHS_FLOOR)

    def build():
        cache = ExecutableCache(manifest_path=None)
        cache.ensure_manifest(k, (1,))
        svc = SolverService(cache=cache, factor_cache=False, batch_max=1,
                            batch_window_s=0.0005, dim_floor=FLOOR, nrhs_floor=NRHS_FLOOR,
                            placement=PlacementPolicy(replicas=1, devices=DEVICES))
        svc.warmup()
        return svc

    faults.configure(f"latency:every=1,ms={TAX_MS}")
    svc = build()
    assert svc._scaler is None
    static = []
    faults.on()
    try:
        for f in _burst(svc, ops, static):
            f.result(60)
    finally:
        faults.off()
        svc.stop()
    monkeypatch.setenv(ctl.SCALE_ENV, POLICY)
    svc = build()
    scaler = svc._scaler
    metrics.reset()  # the evidence window: the elastic leg only
    elastic, fleet = [], [1]
    faults.on()
    try:
        futs = _burst(svc, ops[:FIRST], elastic)
        for now in (0.0, 0.3):
            assert scaler.step(now=now).action == ctl.UP
            fleet.append(len(svc._replicas))
        lanes = [str(r.device) for r in svc._replicas]
        futs += _burst(svc, ops[FIRST:], elastic)
        for f in futs:
            f.result(60)
        faults.reset()  # the tail runs untaxed
        now = 0.3
        while len(svc._replicas) > 1 and now < 30:
            now += 0.5
            scaler.step(now=now)
            fleet.append(len(svc._replicas))
        c = metrics.counters()
        compiles = int(c.get("jit.compilations", 0))
        primes = int(c.get("serve.device_primes", 0))
        gate.publish({
            "static_p99_s": _p99(static), "elastic_p99_s": _p99(elastic),
            "budget_s": BUDGET_S, "replica_peak": max(fleet), "replicas_end": fleet[-1],
            "min_replicas": 1, "max_replicas": 3, "up_threshold": 1.0,
            "new_lane_compiles": compiles - primes, "device_primes": primes,
        })
        books = {"fleet": fleet, "primes": primes, "compiles": compiles,
                 "static": _p99(static), "elastic": _p99(elastic),
                 "lanes": lanes,
                 "errors": {n: c.get(n, 0) for n in ("scale.step_errors", "scale.add_failed",
                                                     "scale.remove_failed")},
                 "moves": (c.get("scale.up", 0), c.get("scale.down", 0))}
    finally:
        faults.reset()
        svc.stop()
    return metrics.dump(str(tmp_path / "scale.jsonl")), books


def test_stepped_scaler_burst_passes_the_capacity_report(tmp_path, monkeypatch):
    path, books = _capacity_drill(tmp_path, monkeypatch)
    assert books["fleet"][:3] == [1, 2, 3] and books["fleet"][-1] == 1, books
    assert books["moves"] == (2, 2) and max(books["fleet"]) == 3
    assert books["lanes"] == DEVICES
    assert books["errors"] == {"scale.step_errors": 0, "scale.add_failed": 0,
                               "scale.remove_failed": 0}
    # the two new lanes' primes are real cold builds on cpu:1 and cpu:2,
    # and every dispatch after them was warm
    assert books["primes"] == 2 and books["compiles"] == 2, books
    assert books["static"] > BUDGET_S >= books["elastic"], books
    rep = subprocess.run([sys.executable, _REPORT, path], capture_output=True, text=True,
                         timeout=60)
    assert rep.returncode == 0, rep.stdout + rep.stderr
    assert "all checks passed" in rep.stdout
    # a hand-made up row below the threshold is an undriven scale-up
    with open(path, "a") as f:
        f.write(json.dumps({"type": "timeline", "kind": "scale", "t_mono": 99.0,
                            "action": "up", "delta": 1, "reason": "by hand",
                            "pressure": 0.5, "replicas": 1}) + "\n")
    bad = subprocess.run([sys.executable, _REPORT, path], capture_output=True, text=True,
                         timeout=60)
    assert bad.returncode == 1, bad.stdout
    assert "[FAIL] scale-ups driven by signal" in bad.stdout
