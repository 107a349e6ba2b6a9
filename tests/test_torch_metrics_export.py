"""The metrics exporter and the span export of slate_tpu_torch against
the JAX package's, on the CPU: the same registry operations dump the
same JSONL rows (timings aside), the report tools read the port's file
unchanged, the Chrome export carries the same event keys for the same
span sequence, and the ring's pressure and eviction count agree for the
same overflow."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slate_tpu.aux import metrics as jmetrics
from slate_tpu.aux import spans as jspans
from slate_tpu_torch import serve
from slate_tpu_torch.aux import metrics, spans

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _env():
    for m in (metrics, jmetrics):
        m.off()
        m.reset()
    # the JAX package's ring is resizable and process-global: a file that
    # ran earlier in this process may have left it at another capacity
    # (``spans.on(ring=1024)``); this file compares at the default one.
    # The port's ring resizes the same way (a soak test sizes it)
    jspans.on(ring=jspans.DEFAULT_RING)
    spans.on(ring=spans.RING)
    for s in (spans, jspans):
        s.off()
        s.clear()
    yield
    for m in (metrics, jmetrics):
        m.off()
        m.reset()
    for s in (spans, jspans):
        s.off()
        s.clear()


def _ops(m):
    m.on()
    m.inc("serve.requests", 3)
    m.inc("serve.tenant.good.admitted")
    m.gauge("serve.queue_depth", 2)
    m.observe("serve.gesv.16x16x4.float64.b4.run", 0.002)
    m.observe("serve.gesv.16x16x4.float64.b4.run", 0.004)
    for v in (0.001, 0.02, 0.3, 0.3, 4.0):
        m.observe_hist("serve.latency.tenant.good.total", v)
    m.record_cost("serve.gesv.16x16x4.float64.b4", {"flops": 1e6, "flops_model": 1e6,
                                                    "bytes_accessed": 4096.0,
                                                    "device_kind": "cpu"})
    m.record_timeline({"t": 1.5, "queue_depth": 2})
    with m.phase("serve.warmup"):
        pass


def _rows(path):
    out = []
    for r in metrics.load_jsonl(path):
        if r["type"] == "meta":
            r = {k: v for k, v in r.items() if k not in ("unix_time", "pid")}
        elif r["type"] == "event":
            r = {k: v for k, v in r.items() if k not in ("t_start", "dur_s", "thread")}
        elif r.get("name") == "serve.warmup":  # the phase's measured wall
            r = {k: v for k, v in r.items() if not k.endswith("_s")}
        out.append(r)
    return out


def test_dump_rows_equal_the_jax_package(tmp_path):
    _ops(metrics)
    _ops(jmetrics)
    got, ref = metrics.dump(str(tmp_path / "p.jsonl")), jmetrics.dump(str(tmp_path / "j.jsonl"))
    assert _rows(got) == _rows(ref)
    assert {r["type"] for r in _rows(got)} == {"meta", "event", "timeline", "counter", "gauge",
                                               "timer", "hist", "cost"}
    summ, jsumm = metrics.summary(), jmetrics.summary()
    for d in (summ, jsumm):
        d["timers"].pop("serve.warmup")
    assert summ == jsumm
    assert metrics.timeline() == jmetrics.timeline()
    assert [ln.split()[:1] for ln in metrics.report().splitlines()] == \
        [ln.split()[:1] for ln in jmetrics.report().splitlines()]
    assert metrics.dump(None) is None  # nowhere to write without the env


def _run_tool(name, *args):
    return subprocess.run([sys.executable, str(REPO / "tools" / name), *args], cwd=REPO,
                          capture_output=True, text=True, timeout=120)


def test_report_tools_read_the_port_jsonl(tmp_path):
    """A tenancy service's dump: tenant_report's fairness verdict and
    warmup_report's bucket table, from the port's file."""
    metrics.on()
    man = str(tmp_path / "m.json")
    svc = serve.SolverService(placement=serve.PlacementPolicy(devices=["cpu"]),
                              cache=serve.ExecutableCache(manifest_path=man), batch_max=4,
                              dim_floor=16, nrhs_floor=4, tenants="good:weight=4;bad:rate=1,burst=1")
    rng = np.random.default_rng(0)
    A = rng.standard_normal((12, 12)) + 12 * np.eye(12)
    B = rng.standard_normal((12, 2))
    try:
        for _ in range(3):
            svc.submit("gesv", A, B, tenant="good").result(timeout=120)
        svc.submit("gesv", A, B, tenant="bad").result(timeout=120)
        with pytest.raises(serve.Rejected):
            svc.submit("gesv", A, B, tenant="bad")
    finally:
        svc.stop()
    path = metrics.dump(str(tmp_path / "out.jsonl"))
    tr = _run_tool("tenant_report.py", path, "--p99-budget", "60", "--well-behaved", "good",
                   "--abusive", "bad")
    assert tr.returncode == 0 and "fairness verdict ok" in tr.stdout, tr.stdout + tr.stderr
    assert _run_tool("tenant_report.py", path, "--abusive", "good").returncode == 1
    wr = _run_tool("warmup_report.py", path, "--manifest", man)
    assert wr.returncode == 0 and "gesv.16x16x4.float64" in wr.stdout, wr.stdout + wr.stderr
    lr = _run_tool("latency_report.py", path)
    assert lr.returncode == 0 and "good" in lr.stdout, lr.stdout + lr.stderr


def _span_sequence(s):
    """Request spans on two lanes, an instant, a context-managed child
    and a lane-less interval, with fixed timestamps."""
    s.on()
    tr = "t-1"
    root = s.record("request", 10.0, 10.5, trace=tr, lane="client", routine="gesv")
    s.record("queued", 10.01, 10.2, trace=tr, parent=root, lane="replica-0")
    s.record("execute", 10.2, 10.4, trace=tr, parent=root, lane="replica-1", batch=4)
    s.record("shed", 10.3, 10.3, lane="client", kind="instant", tenant="bad", level=1)
    s.record("serve.warmup", 9.0, 9.5, kind="phase")
    with s.span("direct", trace=tr, parent=root, lane="replica-0"):
        s.annotate(outcome="ok")


def test_chrome_export_equal_event_keys(tmp_path):
    _span_sequence(spans)
    _span_sequence(jspans)
    docs = []
    for s, name in ((spans, "p.json"), (jspans, "j.json")):
        with open(s.export_chrome(str(tmp_path / name), process_name="host-0")) as f:
            docs.append(json.load(f))
    got, ref = docs
    assert set(got) == set(ref) == {"traceEvents", "displayTimeUnit"}

    def shape(doc):
        return [(e["ph"], e["name"], e.get("cat"), sorted(e), sorted(e.get("args", {})))
                for e in doc["traceEvents"]]

    assert shape(got) == shape(ref)
    fixed = lambda doc: [e for e in doc["traceEvents"] if e["name"] != "direct"]  # noqa: E731
    strip = lambda e: {k: v for k, v in e.items() if k not in ("pid", "args")}  # noqa: E731
    assert [strip(e) for e in fixed(got)] == [strip(e) for e in fixed(ref)]
    assert {k: [sp.name for sp in v] for k, v in spans.by_trace().items()} == \
        {k: [sp.name for sp in v] for k, v in jspans.by_trace().items()}


def test_ring_pressure_and_evictions_equal():
    for s in (spans, jspans):
        s.on()
        for i in range(spans.RING + 123):
            s.record("x", float(i), float(i) + 0.5)
    assert spans.pressure() == jspans.pressure()
    assert spans.evicted() == jspans.evicted() == 123
    assert spans.capacity() == jspans.capacity() == spans.RING
    assert spans.pressure()["window_s"] == spans.RING - 1 + 0.5
    spans.clear()
    assert spans.pressure() == {"capacity": spans.RING, "size": 0, "evicted": 0,
                                "window_s": 0.0}
