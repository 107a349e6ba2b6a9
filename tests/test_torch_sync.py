"""The checked synchronization runtime of slate_tpu_torch against the JAX
package's, on the CPU: a scripted lock-order inversion and an unguarded
cross-thread field give the same violation kinds and names in both, the
seeded yield coin flips the same for the same seed and thread name, the
factories return plain ``threading`` objects while the runtime is off,
and a two-lane CPU service stream (tenants, certification, hedging, a
replica added and removed) in a fresh interpreter armed by
``SLATE_TPU_SYNC_CHECK=1,seed=7,yield=0.2`` records no violation, in a
dump that ``tools/race_report.py`` passes."""

import json
import os
import subprocess
import sys
import threading
import types
from pathlib import Path

import pytest

from slate_tpu.aux import sync as jsync
from slate_tpu_torch.aux import metrics
from slate_tpu_torch.aux import sync

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _reset():
    for s in (sync, jsync):
        s.reset()
    yield
    for s in (sync, jsync):
        s.reset()


def _inversion(s):
    s.configure("1")
    a, b = s.Lock(name="order.A"), s.Lock(name="order.B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    return s.violations()


class Shared:
    """A probed object (the field label is ``Shared.value``)."""


def _unguarded(s):
    """Two threads touch ``Shared.value`` in turn (1, 2, 1), each under
    its own lock, ordered only by plain Events (no happens-before edge):
    the lockset empties at the third access."""
    s.configure("1")
    obj, l1, l2 = Shared(), s.Lock(name="field.L1"), s.Lock(name="field.L2")
    go = [threading.Event() for _ in range(3)]

    def touch(lock, steps):
        for i in steps:
            go[i].wait(30)
            with lock:
                s.guarded(obj, "value")
            if i + 1 < len(go):
                go[i + 1].set()

    ts = [threading.Thread(target=touch, args=(l1, (0, 2))),
          threading.Thread(target=touch, args=(l2, (1,)))]
    for t in ts:
        t.start()
    go[0].set()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    return s.violations()


def test_lock_order_inversion_same_in_both():
    got, ref = _inversion(sync), _inversion(jsync)
    keys = ("kind", "locks", "cycle")
    assert [{k: v[k] for k in keys} for v in got] == [{k: v[k] for k in keys} for v in ref]
    assert got[0]["kind"] == "lock_order" and got[0]["locks"] == ["order.B", "order.A"]
    assert all(len(st) > 0 for st in got[0]["stacks"])
    assert sync.order_edges() == jsync.order_edges()


def test_unguarded_field_same_in_both():
    metrics.on()
    try:
        with metrics.deltas() as d:
            got = _unguarded(sync)
            assert d.get("sync.violation.lockset") == 1
    finally:
        metrics.off()
        metrics.reset()
    ref = _unguarded(jsync)
    keys = ("kind", "field", "write")
    assert [{k: v[k] for k in keys} for v in got] == [{k: v[k] for k in keys} for v in ref]
    assert got[0]["kind"] == "lockset" and got[0]["field"] == "Shared.value"
    assert sync.report()["field_names"] == jsync.report()["field_names"] == ["Shared.value"]


def _coins(s, monkeypatch, name, n=64):
    """The yield decisions of ``n`` checked acquisitions on a thread
    named ``name`` (True = slept)."""
    slept = []
    shim = types.SimpleNamespace(**{k: getattr(s.time, k) for k in dir(s.time)
                                    if not k.startswith("_")})
    shim.sleep = lambda sec: slept.append(sec)
    monkeypatch.setattr(s, "time", shim)
    s.configure("1,seed=7,yield=0.3,yield_us=5")
    lk = s.Lock(name="coin")
    flags = []

    def run():
        for _ in range(n):
            before = len(slept)
            with lk:
                pass
            flags.append(len(slept) > before)

    t = threading.Thread(target=run, name=name)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    return flags


def test_yield_coin_sequence_equal(monkeypatch):
    for name in ("slate-serve-worker-0", "client"):
        got, ref = _coins(sync, monkeypatch, name), _coins(jsync, monkeypatch, name)
        assert got == ref and 5 < sum(got) < 40


def test_factories_plain_when_off():
    assert not sync.is_on()
    assert type(sync.Lock(name="x")) is type(threading.Lock())
    assert type(sync.RLock(name="x")) is type(threading.RLock())
    assert type(sync.Condition(name="x")) is threading.Condition
    sync.configure("1")
    assert type(sync.Lock(name="x")).__name__ == "_CheckedLock"
    assert sync.configure("0") is False and not sync.is_on()
    for bad in ("2", "1,seed", "1,yield=2", "1,bogus=1"):
        with pytest.raises(ValueError):
            sync.configure(bad)


_STREAM = r"""
import json, sys, time
import numpy as np, torch
torch.set_num_threads(1)
from slate_tpu_torch import serve
from slate_tpu_torch.aux import metrics, sync
assert sync.is_on()
metrics.on()
svc = serve.SolverService(placement=serve.PlacementPolicy(replicas=2, devices=["cpu"]),
                          tenants="gold:weight=4;free:rate=1000,share=0.5",
                          integrity="full", batch_max=4, batch_window_s=0.002,
                          dim_floor=16, nrhs_floor=4)
rng = np.random.default_rng(0)
n = 24
ops = []
for i in range(4):
    G = rng.standard_normal((n, n))
    ops.append(("posv", G @ G.T + n * np.eye(n)) if i % 2 else ("gesv", G + 2 * n**0.5 * np.eye(n)))
Bs = [rng.standard_normal((n, 3)) for _ in range(5)]
for r, A in ops[:2]:
    svc.submit(r, A, Bs[0]).result(120)
svc.warmup()
futs = [svc.submit(ops[i % 4][0], ops[i % 4][1], Bs[i % 5], tenant=("gold", "free")[i % 2])
        for i in range(40)]
name = svc.add_replica()
svc.remove_replica(name)
Xs = [f.result(120) for f in futs]
svc.stop()
res = max(float(np.abs(ops[i % 4][1] @ X - Bs[i % 5]).max()) for i, X in enumerate(Xs))
sync.dump(sys.argv[1])
print(json.dumps({"residual": res, "violations": len(sync.violations()),
                  "checked": metrics.counters().get("serve.integrity.checked", 0)}))
"""


def test_checked_service_stream_clean(tmp_path):
    dump = tmp_path / "sync.json"
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "SLATE_TPU_SYNC_CHECK": "1,seed=7,yield=0.2"}
    out = subprocess.run([sys.executable, "-c", _STREAM, str(dump)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["violations"] == 0 and got["residual"] < 1e-9 and got["checked"] >= 40
    doc = json.loads(dump.read_text())
    assert doc["enabled"] and doc["seed"] == 7 and doc["yield_p"] == 0.2
    assert {"_Replica.q", "_Replica.inflight", "_Replica.stopping"} <= set(doc["field_names"])
    rr = subprocess.run([sys.executable, str(REPO / "tools" / "race_report.py"), str(dump),
                         "--quiet"], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert rr.returncode == 0 and "race-report: clean" in rr.stdout, rr.stdout


def test_race_report_fails_a_dump_with_a_violation(tmp_path):
    """The verdict tool can fail on the port's dump: an inversion."""
    _inversion(sync)
    dump = sync.dump(str(tmp_path / "bad.json"))
    rr = subprocess.run([sys.executable, str(REPO / "tools" / "race_report.py"), dump,
                         "--quiet"], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert rr.returncode == 1 and "lock_order" in rr.stdout
