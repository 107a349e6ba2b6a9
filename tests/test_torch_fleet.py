"""The port's fleet tier on the CPU (ROADMAP.md Queue 1 item 7c3): the
cases of tests/test_fleet.py on ``slate_tpu_torch.fleet`` (wire framing,
spec parsing, the residual certificate, router edge cases on a fake
``_rpc``, the worker over a fake service, the stitch / merge / report
tools on the port's own dumps, the serve api's wiring, spawned workers
end to end), then parity with the JAX package on the same seeded numpy
inputs: wire frames crossing between the packages both ways, ``parse_fleet``
over a table of specs, one scripted fake-RPC sequence through both
routers (resolutions and ``fleet.*`` counters), ``_rebuild_exc``,
``observe_burn`` / ``quota_remaining`` on one clock, and a spawned port
worker's gesv / posv X against ``slate_tpu`` and numpy (50 n eps).  The
JAX fleet drill and its escape leg run on two spawned CPU workers
(``chip_smoke.py`` phase 22 legs (a) and (b)), judged by
``tools/fleet_report.py``.

Spawned workers carry ``SLATE_TPU_FLEET_DEVICE=cpu`` in their spawn
environment: without it a worker serves on cuda:0, and here its requests
fail typed."""

import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import types
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu.aux import faults as jfaults
from slate_tpu.aux import metrics as jmetrics
from slate_tpu.fleet import router as jrouter
from slate_tpu.fleet import wire as jwire
from slate_tpu.fleet import worker as jworker
from slate_tpu.serve import admission as jadm
from slate_tpu_torch.aux import faults, metrics, spans
from slate_tpu_torch.exceptions import DistributedException, NumericalError
from slate_tpu_torch.fleet import (
    FleetError,
    FleetRouter,
    FleetWorker,
    HostDead,
    parse_fleet,
    wire,
)
from slate_tpu_torch.fleet import router as trouter
from slate_tpu_torch.fleet.router import HOST_DEAD, HOST_LIVE, HOST_REJOINED, _rebuild_exc
from slate_tpu_torch.fleet.worker import DEVICE_ENV, device_from_env
from slate_tpu_torch.integrity.policy import residual_certificate
from slate_tpu_torch.serve import admission as tadm
from slate_tpu_torch.serve.service import Rejected

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOOLS = os.path.join(_REPO, "tools")
#: a spawned CPU worker: the device variable and the repo on its path
CPU_WORKER = {DEVICE_ENV: "cpu", "PYTHONPATH": _REPO, "SLATE_TPU_FAULTS": None,
              "SLATE_TPU_METRICS": None}


@pytest.fixture(autouse=True)
def metrics_on():
    torch.set_num_threads(1)
    for m in (metrics, jmetrics):
        m.off()
        m.reset()
        m.on()
    yield
    for f in (faults, jfaults):
        f.reset()
    for m in (metrics, jmetrics):
        m.off()
        m.reset()
    spans.on(ring=spans.RING)
    spans.off()
    spans.clear()


def _counter(name: str) -> float:
    return float(metrics.counters().get(name, 0.0))


def _fleet_counters(m) -> dict:
    return {k: v for k, v in m.counters().items() if k.startswith("fleet.")}


# ---------------------------------------------------------------------------
# wire framing
# ---------------------------------------------------------------------------


class TestWire:
    def test_roundtrip_header_and_arrays(self):
        a, b = socket.socketpair()
        try:
            A = np.arange(12, dtype=np.float32).reshape(3, 4)
            B = np.ones((3, 1), dtype=np.float64)
            wire.send_msg(a, {"op": "solve", "n": 3}, {"A": A, "B": B})
            header, arrays = wire.recv_msg(b)
            assert header == {"op": "solve", "n": 3}
            np.testing.assert_array_equal(arrays["A"], A)
            np.testing.assert_array_equal(arrays["B"], B)
            assert arrays["A"].dtype == np.float32
        finally:
            a.close()
            b.close()

    def test_noncontiguous_array_roundtrips(self):
        a, b = socket.socketpair()
        try:
            A = np.arange(16, dtype=np.float32).reshape(4, 4).T
            wire.send_msg(a, {}, {"A": A})
            _, arrays = wire.recv_msg(b)
            np.testing.assert_array_equal(arrays["A"], A)
        finally:
            a.close()
            b.close()

    def test_eof_mid_frame_raises_connection_error(self):
        a, b = socket.socketpair()
        a.sendall(b"\x00\x00\x10\x00partial")
        a.close()
        try:
            with pytest.raises(ConnectionError):
                wire.recv_msg(b)
        finally:
            b.close()

    def test_oversized_header_refused(self):
        a, b = socket.socketpair()
        a.sendall(struct.pack(">I", wire.MAX_HEADER_BYTES + 1))
        try:
            with pytest.raises(wire.ProtocolError):
                wire.recv_msg(b)
        finally:
            a.close()
            b.close()


_WIRE_DTYPES = [np.float32, np.float64, np.complex64, np.complex128]
_PAIRS = [(jwire, wire), (wire, jwire)]


def _frame_arrays(dtype):
    rng = np.random.default_rng(7)
    A = rng.standard_normal((5, 3))
    if np.issubdtype(dtype, np.complexfloating):
        A = A + 1j * rng.standard_normal((5, 3))
    return {"A": A.astype(dtype), "B": np.zeros((0, 3), dtype), "X": np.ones((4, 0), dtype),
            "v": A[:, 0].astype(dtype)}


@pytest.mark.parametrize("dtype", _WIRE_DTYPES)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_wire_frames_cross_between_packages(dtype, direction):
    """A frame sent by one package's ``send_msg`` decodes in the other's
    ``recv_msg`` to equal arrays (dtype, shape, bytes) and header; empty
    arrays included."""
    send, recv = _PAIRS[direction == "port_to_jax"]
    arrays = _frame_arrays(dtype)
    a, b = socket.socketpair()
    try:
        header = {"op": "solve", "routine": "gesv", "trace": "t1-2", "deadline": 1.5}
        send.send_msg(a, header, arrays)
        got_h, got = recv.recv_msg(b)
    finally:
        a.close()
        b.close()
    assert got_h == header
    assert list(got) == list(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v)


def _over_cap_frames():
    big = json.dumps({"arrays": [["A", "<f8", [1 << 20, 1 << 20]]]}).encode()
    neg = json.dumps({"arrays": [["A", "<f8", [-4, 2]]]}).encode()
    bad = json.dumps({"arrays": [["A", "nodtype", [2]]]}).encode()
    return {"header": struct.pack(">I", wire.MAX_HEADER_BYTES + 1),
            "array": struct.pack(">I", len(big)) + big,
            "negative": struct.pack(">I", len(neg)) + neg,
            "dtype": struct.pack(">I", len(bad)) + bad,
            "not_json": struct.pack(">I", 3) + b"{{{",
            "not_object": struct.pack(">I", 2) + b"[]"}


@pytest.mark.parametrize("case", sorted(_over_cap_frames()))
def test_malformed_frames_refused_by_both(case):
    """Over-cap lengths and malformed manifests raise ProtocolError in
    both packages' readers, before any payload is allocated."""
    assert wire.MAX_HEADER_BYTES == jwire.MAX_HEADER_BYTES == 16 << 20
    assert wire.MAX_ARRAY_BYTES == jwire.MAX_ARRAY_BYTES == 1 << 31
    raw = _over_cap_frames()[case]
    for mod in (wire, jwire):
        a, b = socket.socketpair()
        try:
            a.sendall(raw)
            with pytest.raises(mod.ProtocolError):
                mod.recv_msg(b)
        finally:
            a.close()
            b.close()


# ---------------------------------------------------------------------------
# spec parsing
# ---------------------------------------------------------------------------


class TestParseFleet:
    def test_spawn_and_knobs(self):
        kw = parse_fleet("spawn=3,cert=0.5,hedge=1.5,retries=4,redispatch=1,dead_after=2,respawn")
        assert kw == {"spawn": 3, "cert": "sample=0.5", "hedge_s": 1.5, "rpc_retries": 4,
                      "redispatch_max": 1, "dead_after": 2, "respawn": True}

    def test_connect_addrs(self):
        kw = parse_fleet("connect=10.0.0.1:9001+:9002")
        assert kw["connect"] == (("10.0.0.1", 9001), ("127.0.0.1", 9002))

    def test_cert_spellings(self):
        assert parse_fleet("spawn=1,cert=full")["cert"] == "full"
        assert parse_fleet("spawn=1,cert=off")["cert"] == "off"
        assert parse_fleet("spawn=1,cert=sample=0.3")["cert"] == "sample=0.3"

    def test_needs_hosts(self):
        with pytest.raises(ValueError, match="spawn=<n> or connect"):
            parse_fleet("cert=full")

    def test_unknown_key_names_itself(self):
        with pytest.raises(ValueError, match="bogus"):
            parse_fleet("spawn=1,bogus=3")


_SPECS = [
    "spawn=2", "spawn=2,cert=full,hedge=0.5,seed=9", "connect=127.0.0.1:7701+:7702,cert=off",
    "spawn=1,threshold=0.7,cooldown=1.5,alpha=0.25,respawn", " spawn=3 , retries=0,,",
    "spawn=1,cert=sample=0.1", "spawn=1,redispatch=0,dead_after=5",
    "cert=full", "", "spawn=1,bogus=3", "spawn=x", "spawn=1,cert=abc", "connect=host:port",
    "spawn=1,respawn=1", "spawn=0", "spawn=1,hedge",
]


@pytest.mark.parametrize("spec", _SPECS)
def test_parse_fleet_matches_jax(spec):
    """The same kwargs, or the same error class and message."""
    def run(fn):
        try:
            return "ok", fn(spec)
        except Exception as e:  # noqa: BLE001 -- compared across packages
            return type(e).__name__, str(e)

    assert run(parse_fleet) == run(jrouter.parse_fleet)


# ---------------------------------------------------------------------------
# residual certificate
# ---------------------------------------------------------------------------


class TestResidualCertificate:
    def _spd(self, n=8, dtype=np.float32):
        rng = np.random.default_rng(5)
        A = rng.standard_normal((n, n))
        return (A @ A.T + n * np.eye(n)).astype(dtype)

    def test_correct_solve_passes(self):
        A = self._spd()
        X = np.linalg.solve(A, np.ones((8, 2), dtype=np.float32))
        assert residual_certificate("gesv", A, X, np.ones((8, 2)))

    def test_corrupted_solve_fails(self):
        A = self._spd()
        B = np.ones((8, 2), dtype=np.float32)
        X = np.linalg.solve(A, B)
        X[0, 0] += 1.0
        assert not residual_certificate("gesv", A, X, B)

    def test_dtype_rebases_to_delivered_precision(self):
        # float64 operands, float32 solve: the fence uses float32's eps
        A = self._spd(dtype=np.float64)
        B = np.ones((8, 2), dtype=np.float64)
        X = np.linalg.solve(A.astype(np.float32), B.astype(np.float32))
        assert residual_certificate("gesv", A, X, B)

    def test_posv_ignores_upper_junk(self):
        A = self._spd()
        B = np.ones((8, 1), dtype=np.float32)
        X = np.linalg.solve(A, B)
        junk = np.array(A)
        junk[np.triu_indices(8, 1)] = 777.0  # posv contract: lower only
        assert residual_certificate("posv", junk, X, B)
        assert not residual_certificate("gesv", junk, X, B)

    def test_gels_vacuous(self):
        assert residual_certificate("gels", np.eye(3), np.zeros(3), np.ones(3))


# ---------------------------------------------------------------------------
# router edge cases (fake RPC)
# ---------------------------------------------------------------------------


def _fake_router(n=2, cls=FleetRouter, **kw):
    """Connect-mode router that never opens a socket: tests install a fake
    ``_rpc`` before any dispatch."""
    kw.setdefault("heartbeat_s", 60.0)  # quiet during the test
    kw.setdefault("cert", "off")
    kw.setdefault("rpc_retries", 0)
    addrs = tuple(("127.0.0.1", 59000 + i) for i in range(n))
    return cls(connect=addrs, **kw)


def _install_rpc(r, fn):
    r._rpc = types.MethodType(fn, r)


def _ok_reply(X):
    return {"ok": True, "op": "solve"}, {"X": X}


class TestRouterEdgeCases:
    A = np.eye(4, dtype=np.float32)
    B = np.ones((4, 1), dtype=np.float32)
    X = np.ones((4, 1), dtype=np.float32)

    def test_least_loaded_pick_and_exclusion(self):
        r = _fake_router(n=3)
        _install_rpc(r, lambda self, *a, **k: _ok_reply(None))
        r.start()
        try:
            with r._lock:
                r._hosts["0"].inflight = 5
                r._hosts["1"].queue_depth = 1
                r._hosts["2"].queue_depth = 3
                assert r._pick_host_locked().name == "1"
                assert r._pick_host_locked(exclude={"1"}).name == "2"
                r._hosts["2"].state = HOST_DEAD
                assert r._pick_host_locked(exclude={"1"}).name == "0"
                assert r._pick_host_locked(exclude={"0", "1"}) is None
        finally:
            r.stop(drain=False)

    def test_host_death_with_hedge_twin_resolves_exactly_once(self):
        r = _fake_router(n=2, redispatch_max=2)
        gate = threading.Event()

        def rpc(self, host, header, arrays=None, **kw):
            if header.get("op") != "solve":
                return {"ok": True}, {}
            if host.name == "0":
                gate.wait(timeout=30)
                raise ConnectionError("host 0 died mid-RPC")
            return _ok_reply(TestRouterEdgeCases.X)

        _install_rpc(r, rpc)
        r.start()
        try:
            fut = r.submit("gesv", self.A, self.B, deadline=30.0)
            with r._lock:
                assert len(r._pending) == 1
                p = next(iter(r._pending.values()))
                p.hedged = True  # hedge twin onto host 1 while the primary hangs
            r._spawn_run(p, r._hosts["1"], hedge=True)
            X = fut.result(timeout=30)
            # the fleet declares host 0 dead while the twin already won
            r._note_host_failure(r._hosts["0"], hard=True)
            gate.set()  # the stuck RPC now fails too: a no-op
            time.sleep(0.2)
            assert fut.done() and fut.result() is not None
            np.testing.assert_array_equal(X, self.X)
            assert _counter("fleet.delivered") == 1
            assert _counter("fleet.typed_errors") == 0
            assert _counter("fleet.hedge.won") == 1
        finally:
            gate.set()
            r.stop(drain=False)

    def test_host_death_before_hedge_resolution_survivor_delivers(self):
        r = _fake_router(n=2, redispatch_max=2)
        gate0, gate1 = threading.Event(), threading.Event()

        def rpc(self, host, header, arrays=None, **kw):
            if header.get("op") != "solve":
                return {"ok": True}, {}
            if host.name == "0":
                gate0.wait(timeout=30)
                raise ConnectionError("host 0 died")
            gate1.wait(timeout=30)
            return _ok_reply(TestRouterEdgeCases.X)

        _install_rpc(r, rpc)
        r.start()
        try:
            fut = r.submit("gesv", self.A, self.B, deadline=30.0)
            with r._lock:
                p = next(iter(r._pending.values()))
                p.hedged = True
            r._spawn_run(p, r._hosts["1"], hedge=True)
            # both inflight; host 0 dies hard: its member is doomed, but the
            # hedge twin is alive, so no typed error: the survivor delivers
            r._note_host_failure(r._hosts["0"], hard=True)
            gate0.set()
            assert not fut.done()
            gate1.set()
            np.testing.assert_array_equal(fut.result(timeout=30), self.X)
            assert _counter("fleet.delivered") == 1
            assert _counter("fleet.typed_errors") == 0
        finally:
            gate0.set()
            gate1.set()
            r.stop(drain=False)

    def test_redispatch_after_host_death(self):
        r = _fake_router(n=2, redispatch_max=2)
        gate = threading.Event()

        def rpc(self, host, header, arrays=None, **kw):
            if header.get("op") != "solve":
                return {"ok": True}, {}
            if host.name == "0":
                gate.wait(timeout=30)
                raise ConnectionError("host 0 died")
            return _ok_reply(TestRouterEdgeCases.X)

        _install_rpc(r, rpc)
        r.start()
        try:
            fut = r.submit("gesv", self.A, self.B, deadline=30.0)
            time.sleep(0.1)
            # death fail-fast re-dispatches the inflight member to the
            # surviving host without waiting for the stuck RPC
            r._note_host_failure(r._hosts["0"], hard=True)
            np.testing.assert_array_equal(fut.result(timeout=30), self.X)
            gate.set()
            assert _counter("fleet.redispatched") == 1
            assert _counter("fleet.host_dead") == 1
        finally:
            gate.set()
            r.stop(drain=False)

    def test_report_after_death_does_not_resurrect(self):
        r = _fake_router(n=2)
        _install_rpc(r, lambda self, *a, **k: ({"ok": True}, {}))
        r.start()
        try:
            h = r._hosts["0"]
            r._note_host_failure(h, hard=True)
            with r._lock:
                assert h.state == HOST_DEAD
            r._note_report(h, {"queue_depth": 0, "burn": 0.1})
            with r._lock:
                assert h.state == HOST_DEAD  # stats only, never state
            # an answered rpc is the only way back: rejoined, probe pending
            r._note_host_ok(h)
            with r._lock:
                assert h.state == HOST_REJOINED
                assert h.probe_pending
        finally:
            r.stop(drain=False)

    def test_drain_racing_redispatch_resolves_typed(self):
        r = _fake_router(n=2, redispatch_max=2)
        entered = threading.Event()
        gate = threading.Event()

        def rpc(self, host, header, arrays=None, **kw):
            if header.get("op") != "solve":
                return {"ok": True}, {}
            entered.set()
            gate.wait(timeout=30)
            raise ConnectionError("failed during drain")

        _install_rpc(r, rpc)
        r.start()
        fut = r.submit("gesv", self.A, self.B, deadline=30.0)
        assert entered.wait(timeout=10)
        stopper = threading.Thread(target=r.stop, kwargs={"drain": True, "timeout": 20.0})
        stopper.start()
        time.sleep(0.1)  # stop() is draining; now the member fails
        gate.set()
        with pytest.raises(FleetError):
            fut.result(timeout=30)
        stopper.join(timeout=30)
        assert not stopper.is_alive()
        assert _counter("fleet.redispatched") == 0
        assert _counter("fleet.typed_errors") == 1

    def test_submit_with_no_live_host_fails_typed(self):
        r = _fake_router(n=1)
        _install_rpc(r, lambda self, *a, **k: ({"ok": True}, {}))
        r.start()
        try:
            r._note_host_failure(r._hosts["0"], hard=True)
            fut = r.submit("gesv", self.A, self.B)
            with pytest.raises(HostDead, match="no live fleet host"):
                fut.result(timeout=10)
        finally:
            r.stop(drain=False)

    def test_submit_while_draining_refused(self):
        r = _fake_router(n=1)
        _install_rpc(r, lambda self, *a, **k: ({"ok": True}, {}))
        r.start()
        with r._lock:
            r._draining = True
        with pytest.raises(Rejected, match="draining"):
            r.submit("gesv", self.A, self.B)
        assert _counter("fleet.refused") == 1
        with r._lock:
            r._draining = False
        r.stop(drain=False)

    def test_rejoined_probe_certified_despite_sampling(self):
        # sample=1e-9 would certify ~never; a rejoined host's delivery is
        # checked anyway, and a wrong probe never delivers
        r = _fake_router(n=2, cert="sample=0.000000001")
        bad = np.full((4, 1), 7.0, dtype=np.float32)

        def rpc(self, host, header, arrays=None, **kw):
            if header.get("op") != "solve":
                return {"ok": True}, {}
            if host.name == "0":
                return _ok_reply(bad)  # finite but wrong
            return _ok_reply(np.linalg.solve(arrays["A"], arrays["B"]).astype(np.float32))

        _install_rpc(r, rpc)
        r.start()
        try:
            with r._lock:
                r._hosts["0"].probe_pending = True
                r._hosts["0"].state = HOST_REJOINED
                r._hosts["1"].inflight = 10  # steer the pick to host 0
            X = r.submit("gesv", self.A, self.B, deadline=30.0).result(timeout=30)
            np.testing.assert_allclose(X, self.B, atol=1e-5)
            assert _counter("fleet.cert.checked") >= 1
            assert _counter("fleet.cert.fail") >= 1
            assert _counter("fleet.redispatched") == 1
            with r._lock:
                assert r._hosts["0"].probe_pending  # failed probe: not recovered
        finally:
            r.stop(drain=False)

    def test_unsampled_delivery_skips_certificate(self):
        r = _fake_router(n=1, cert="sample=0.000000001")
        _install_rpc(r, lambda self, host, header, arrays=None, **kw:
                     _ok_reply(TestRouterEdgeCases.X) if header.get("op") == "solve"
                     else ({"ok": True}, {}))
        r.start()
        try:
            r.submit("gesv", self.A, self.B).result(timeout=30)
            assert _counter("fleet.cert.checked") == 0
        finally:
            r.stop(drain=False)

    def test_typed_worker_error_resolves_without_retry(self):
        r = _fake_router(n=2)

        def rpc(self, host, header, arrays=None, **kw):
            if header.get("op") != "solve":
                return {"ok": True}, {}
            return {"ok": False, "error": "NumericalError", "message": "singular",
                    "context": {"routine": "gesv"}}, {}

        _install_rpc(r, rpc)
        r.start()
        try:
            with pytest.raises(NumericalError, match="singular"):
                r.submit("gesv", self.A, self.B).result(timeout=30)
            assert _counter("fleet.redispatched") == 0  # the second host never tried
        finally:
            r.stop(drain=False)

    def test_host_local_rejected_redispatches(self):
        r = _fake_router(n=2)

        def rpc(self, host, header, arrays=None, **kw):
            if header.get("op") != "solve":
                return {"ok": True}, {}
            if host.name == "0":
                return {"ok": False, "error": "Rejected", "message": "queue full",
                        "context": {}}, {}
            return _ok_reply(TestRouterEdgeCases.X)

        _install_rpc(r, rpc)
        r.start()
        try:
            with r._lock:
                r._hosts["1"].inflight = 10
            X = r.submit("gesv", self.A, self.B).result(timeout=30)
            np.testing.assert_array_equal(X, self.X)
            assert _counter("fleet.redispatched") == 1
        finally:
            r.stop(drain=False)

    def test_global_quota_refuses_fleet_wide(self):
        r = _fake_router(n=2, tenants="abuser:rate=1,burst=2;victim:rate=50,burst=20")
        _install_rpc(r, lambda self, host, header, arrays=None, **kw:
                     _ok_reply(TestRouterEdgeCases.X) if header.get("op") == "solve"
                     else ({"ok": True}, {}))
        r.start()
        try:
            rejected = 0
            for _ in range(10):
                try:
                    r.submit("gesv", self.A, self.B, tenant="abuser").result(timeout=30)
                except Rejected:
                    rejected += 1
            assert rejected > 0
            assert _counter("fleet.rejected_quota") == rejected
            # the victim is untouched by the abuser's quota
            r.submit("gesv", self.A, self.B, tenant="victim").result(timeout=30)
        finally:
            r.stop(drain=False)

    def test_rebuild_exc_maps_taxonomy(self):
        e = _rebuild_exc({"error": "Rejected", "message": "queue full",
                          "context": {"routine": "gesv", "tenant": "a"}})
        assert isinstance(e, Rejected)
        assert e.context()["routine"] == "gesv"
        assert e.context()["tenant"] == "a"
        assert isinstance(_rebuild_exc({"error": "NoSuchClass", "message": "x"}), FleetError)

    def test_health_shape(self):
        r = _fake_router(n=2, tenants="a:rate=10,burst=5")
        _install_rpc(r, lambda self, *a, **k: ({"ok": True}, {}))
        r.start()
        try:
            h = r.health()
            assert set(h) == {"hosts", "pending", "draining", "admission", "tenants"}
            assert h["hosts"]["0"]["state"] == HOST_LIVE
            assert "score" in h["hosts"]["0"]
            assert h["admission"] is not None
        finally:
            r.stop(drain=False)

    def test_router_lock_is_the_named_sync_lock(self):
        """The router's lock comes from aux/sync under the JAX module's name
        (the checked runtime's lock-order table keys on it)."""
        r = _fake_router(n=1)
        assert getattr(r._lock, "name", "fleet.FleetRouter._lock") == "fleet.FleetRouter._lock"
        src = open(trouter.__file__).read()
        assert 'sync.Lock(name="fleet.FleetRouter._lock")' in src
        assert src.count("# guarded by: _lock") == open(jrouter.__file__).read().count(
            "# guarded by: _lock")


# ---------------------------------------------------------------------------
# parity: one scripted fake-RPC sequence through both routers
# ---------------------------------------------------------------------------

_SA = np.array([[4.0, 1.0, 0.0], [1.0, 3.0, 1.0], [0.0, 1.0, 2.0]], dtype=np.float32)


def _settle(r):
    """Wait until no member is in flight (deterministic least-loaded picks:
    a dispatch thread decrements its host's inflight after resolving)."""
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with r._lock:
            if all(h.inflight == 0 for h in r._hosts.values()):
                return
        time.sleep(0.002)


def _scenario(name):
    """(router kwargs, fake rpc, requests) of one scripted scenario."""
    good = np.linalg.solve(_SA, np.ones((3, 1), np.float32)).astype(np.float32)

    def ok(self, host, header, arrays=None, **kw):
        if header.get("op") != "solve":
            return {"ok": True}, {}
        return _ok_reply(np.linalg.solve(arrays["A"], arrays["B"]).astype(np.float32))

    def script(host0, host1=ok):
        def rpc(self, host, header, arrays=None, **kw):
            if header.get("op") != "solve":
                return {"ok": True}, {}
            return (host0 if host.name == "0" else host1)(self, host, header, arrays)
        return rpc

    def typed(err):
        return lambda self, host, header, arrays: ({"ok": False, "error": err, "message": "m",
                                                    "context": {"routine": "gesv"}}, {})

    def dead(self, host, header, arrays):
        raise ConnectionError("down")

    reqs = [("gesv", "victim")] * 3
    if name == "ok":
        return {}, ok, reqs
    if name == "typed":
        return {}, script(typed("NumericalError"), typed("NumericalError")), reqs
    if name == "rejected_redispatch":
        return {}, script(typed("Rejected")), reqs
    if name == "deadline_typed":
        return {}, script(typed("DeadlineExceeded")), reqs
    if name == "connection_redispatch":
        return {"dead_after": 5}, script(dead), reqs
    if name == "all_dead":
        return {"dead_after": 1}, script(dead, dead), reqs
    if name == "cert_fail_redispatch":
        bad = lambda self, host, header, arrays: _ok_reply(good + 3.0)  # noqa: E731
        return {"cert": "full"}, script(bad), reqs
    if name == "quota":
        return ({"tenants": "abuser:rate=0.001,burst=2;victim:rate=50,burst=20"}, ok,
                [("gesv", "abuser")] * 5 + [("posv", "victim")])
    if name == "budget_exhausted":
        return {"redispatch_max": 0}, script(dead), reqs
    raise KeyError(name)


_SCENARIOS = ["ok", "typed", "rejected_redispatch", "deadline_typed", "connection_redispatch",
              "all_dead", "cert_fail_redispatch", "quota", "budget_exhausted"]


def _drive(cls, name, m):
    kw, rpc, reqs = _scenario(name)
    r = _fake_router(n=2, cls=cls, **kw)
    _install_rpc(r, rpc)
    r.start()
    out = []
    try:
        for routine, tenant in reqs:
            try:
                X = r.submit(routine, _SA, np.ones((3, 1), np.float32),
                             tenant=tenant).result(timeout=30)
                out.append(("value", X.tolist()))
            except Exception as e:  # noqa: BLE001 -- compared across packages
                out.append((type(e).__name__, getattr(e, "tenant", None)))
            _settle(r)
        states = {k: v["state"] for k, v in r.health()["hosts"].items()}
    finally:
        r.stop(drain=False)
    return out, states, _fleet_counters(m)


@pytest.mark.parametrize("name", _SCENARIOS)
def test_scripted_rpc_sequence_matches_jax(name):
    """The same fake-RPC script through the port's router and the JAX
    package's: equal resolutions (value or typed class), equal host states
    and equal ``fleet.*`` counters."""
    got = _drive(FleetRouter, name, metrics)
    ref = _drive(jrouter.FleetRouter, name, jmetrics)
    assert got == ref


def test_rpc_retry_ladder_matches_jax():
    """The real ``_rpc`` against a live worker over a fake service, with
    ``rpc_timeout:every=2`` armed in each package: the same deliveries,
    the same seeded retries (``fleet.rpc_retries``), the same counters."""
    def run(router_cls, worker_cls, fmod, m):
        w = worker_cls(host="127.0.0.1", service=_FakeService())
        w.bind()
        t = threading.Thread(target=w.serve_forever, kwargs={"announce": False}, daemon=True)
        t.start()
        r = router_cls(connect=(("127.0.0.1", w.port),), cert="full", heartbeat_s=60.0,
                       rpc_retries=1, seed=3)
        fmod.configure("rpc_timeout:every=2")
        fmod.on()
        out = []
        try:
            for i in range(5):
                B = np.full((3, 1), float(i + 1), np.float32)
                try:
                    out.append(r.submit("gesv", _SA, B).result(timeout=30).tolist())
                except Exception as e:  # noqa: BLE001 -- compared across packages
                    out.append(type(e).__name__)
        finally:
            fmod.reset()
            r.stop(drain=False)
            w.shutdown()
            t.join(timeout=5)
        return out, _fleet_counters(m)

    got = run(FleetRouter, FleetWorker, faults, metrics)
    ref = run(jrouter.FleetRouter, jworker.FleetWorker, jfaults, jmetrics)
    assert got == ref
    assert got[1].get("fleet.rpc_retries", 0) > 0


_EXC_NAMES = ["Rejected", "Shed", "DeadlineExceeded", "NumericalError", "InvalidInput",
              "DimensionError", "OptionError", "DistributedException", "SlateError",
              "FleetError", "HostDead", "FleetTimeout", "ProtocolError", "RuntimeError",
              "NoSuchClass", None]


@pytest.mark.parametrize("name", _EXC_NAMES)
def test_rebuild_exc_matches_jax(name):
    """The same error name resolves to the same class name, with the same
    context fields, in both packages."""
    reply = {"error": name, "message": "msg",
             "context": {"routine": "posv", "tenant": "t", "attempt": 2, "junk": 1}}
    e, j = _rebuild_exc(reply), jrouter._rebuild_exc(reply)
    assert type(e).__name__ == type(j).__name__
    assert e.context() == j.context() and str(e) == str(j)


# ---------------------------------------------------------------------------
# admission: observe_burn / quota_remaining against the JAX package
# ---------------------------------------------------------------------------


def test_observe_burn_and_quota_remaining_match_jax():
    spec = "abuser:rate=4,burst=4;victim:rate=500,burst=100"
    planes = [mod.AdmissionControl(tenants=mod.parse_tenants(spec), clock=lambda: 0.0)
              for mod in (tadm, jadm)]
    clock = [0.0, 0.05, 0.1, 0.3, 0.31, 0.6, 1.0, 1.5, 2.2, 3.0, 4.5, 6.0, 9.0]
    burns = [0.2, 1.8, 2.5, 3.0, 0.4, 2.2, 0.1, 0.0, 0.05, 0.0, 0.0, 0.0, 0.0]
    seen = [[], []]
    for i, (t, burn) in enumerate(zip(clock, burns)):
        for k, adm in enumerate(planes):
            adm.tick(t)
            took = adm.quota_take("abuser", t) if i % 2 == 0 else None
            adm.observe_burn(burn, t)
            seen[k].append((took, adm.quota_remaining("abuser", t),
                            adm.quota_remaining("victim", t), adm.quota_remaining("nobody", t),
                            adm.overload.level, round(adm.overload.ewma, 12),
                            adm.sheds(2), adm.snapshot()["overload_level"]))
    assert seen[0] == seen[1]
    assert max(s[4] for s in seen[0]) >= 1  # the burns raised the level
    assert seen[0][-1][4] < max(s[4] for s in seen[0])  # and quiet lowered it


def test_observe_burn_emits_the_overload_transition():
    """An external burn moves the level through the same emission as a
    finished request: the ``serve.overload.level`` gauge and one
    ``serve.overload.enter`` a step up; no tenant is touched."""
    adm = tadm.AdmissionControl(tenants=tadm.parse_tenants("a:rate=1"), clock=lambda: 0.0)
    for t in range(6):
        adm.observe_burn(3.0, 0.1 * t)
    level = adm.overload.level
    assert level >= 1
    assert metrics.counters().get("serve.overload.enter") == level
    assert metrics.gauges()["serve.overload.level"] == level
    assert adm.quota_remaining("a", 0.5) is None  # no bucket state until a take
    assert adm.quota_take("a", 0.5) and adm.quota_remaining("a", 0.5) == 0.0


# ---------------------------------------------------------------------------
# worker front-end (fake service, real sockets)
# ---------------------------------------------------------------------------


class _FakeService:
    def __init__(self, fail=None):
        self.fail = fail
        self.seen = []

    def submit(self, routine, A, B, **kw):
        self.seen.append((routine, dict(kw)))
        fut = Future()
        if self.fail is not None:
            fut.set_exception(self.fail)
        else:
            fut.set_result(np.linalg.solve(A, B))
        return fut

    def health(self):
        return {"phase": "ready", "queue_depth": 2, "inflight": 1,
                "admission": {"burn_ewma": 0.25}}

    def stop(self, **kw):
        self.stopped = True


def _serve(w):
    w.bind()
    t = threading.Thread(target=w.serve_forever, kwargs={"announce": False}, daemon=True)
    t.start()
    return t


@pytest.fixture()
def live_worker():
    svc = _FakeService()
    w = FleetWorker(host="127.0.0.1", service=svc)
    t = _serve(w)
    yield w, svc
    w.shutdown()
    t.join(timeout=5)


def _call(w, header, arrays=None):
    with socket.create_connection(("127.0.0.1", w.port), timeout=10) as s:
        wire.send_msg(s, header, arrays)
        return wire.recv_msg(s)


class TestWorker:
    def test_solve_roundtrip_adopts_trace(self, live_worker):
        w, svc = live_worker
        A = np.eye(3, dtype=np.float64)
        B = np.full((3, 1), 2.0)
        reply, arrays = _call(w, {"op": "solve", "routine": "gesv", "deadline": 5.0,
                                  "tenant": "a", "trace": "t1-2"}, {"A": A, "B": B})
        assert reply["ok"]
        np.testing.assert_array_equal(arrays["X"], B)
        routine, kw = svc.seen[0]
        assert routine == "gesv"
        assert kw["trace_id"] == "t1-2" and kw["tenant"] == "a" and kw["deadline"] == 5.0

    def test_typed_error_crosses_by_name(self):
        svc = _FakeService(fail=Rejected("full").with_context(routine="gesv"))
        w = FleetWorker(host="127.0.0.1", service=svc)
        t = _serve(w)
        try:
            reply, _ = _call(w, {"op": "solve", "routine": "gesv"},
                             {"A": np.eye(2), "B": np.ones((2, 1))})
            assert reply == {"ok": False, "error": "Rejected", "message": "full",
                             "context": {"routine": "gesv"}}
        finally:
            w.shutdown()
            t.join(timeout=5)

    def test_report_op(self, live_worker):
        w, _ = live_worker
        reply, _ = _call(w, {"op": "report"})
        assert reply["ok"] and reply["phase"] == "ready"
        assert reply["queue_depth"] == 2 and reply["burn"] == 0.25
        assert reply["pid"] == os.getpid()

    def test_unknown_op_is_typed(self, live_worker):
        w, _ = live_worker
        reply, _ = _call(w, {"op": "frobnicate"})
        assert not reply["ok"] and reply["error"] == "ProtocolError"

    def test_replies_match_the_jax_worker(self):
        """The same ops against a port worker and a JAX worker over the same
        fake service give the same replies (pid and time aside)."""
        def replies(cls):
            svc = _FakeService()
            w = cls(host="127.0.0.1", service=svc)
            t = _serve(w)
            try:
                out = []
                for h, a in (({"op": "solve", "routine": "gesv", "trace": "t5-1"},
                              {"A": 2 * np.eye(3), "B": np.ones((3, 2))}),
                             ({"op": "report"}, None), ({"op": "ping"}, None),
                             ({"op": "x"}, None), ({"op": "dump"}, None)):
                    reply, arrays = _call(w, h, a)
                    reply.pop("pid", None)
                    reply.pop("t", None)
                    out.append((reply, {k: v.tolist() for k, v in arrays.items()}))
                return out
            finally:
                w.shutdown()
                t.join(timeout=5)

        assert replies(FleetWorker) == replies(jworker.FleetWorker)

    def test_report_before_the_first_request_builds_nothing(self):
        """A heartbeat to a worker whose service is not built yet answers at
        once (phase "cold", nothing queued) and leaves it unbuilt."""
        w = FleetWorker(host="127.0.0.1", device=torch.device("cpu"))
        t = _serve(w)
        try:
            reply, _ = _call(w, {"op": "report"})
            assert reply["ok"] and reply["phase"] == "cold"
            assert (reply["queue_depth"], reply["inflight"], reply["burn"]) == (0, 0, None)
            assert w._service is None
        finally:
            w.shutdown()
            t.join(timeout=5)

    def test_an_op_that_raises_answers_typed(self):
        class Broken(_FakeService):
            def health(self):
                raise DistributedException("serve: no CUDA device")

        w = FleetWorker(host="127.0.0.1", service=Broken())
        t = _serve(w)
        try:
            reply, _ = _call(w, {"op": "report"})
            assert reply == {"ok": False, "error": "DistributedException",
                             "message": "serve: no CUDA device"}
            reply, _ = _call(w, {"op": "ping"})  # the host stays up
            assert reply == {"ok": True, "op": "ping"}
        finally:
            w.shutdown()
            t.join(timeout=5)


def test_device_variable(monkeypatch):
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    assert device_from_env() is None
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    assert device_from_env() == torch.device("cpu")
    monkeypatch.setenv(DEVICE_ENV, "cuda:1")
    assert device_from_env() == torch.device("cuda", 1)
    for bad in ("bogus", "meta", "gpu0"):
        monkeypatch.setenv(DEVICE_ENV, bad)
        with pytest.raises(ValueError, match=DEVICE_ENV):
            device_from_env()


# ---------------------------------------------------------------------------
# tools: trace_stitch / metrics_merge --tag / fleet_report, on the port's dumps
# ---------------------------------------------------------------------------


def _run_tool(name, *args):
    return subprocess.run([sys.executable, os.path.join(_TOOLS, name), *args],
                          capture_output=True, text=True, timeout=120)


def _chrome(pid, events, pname=None):
    rows = []
    if pname:
        rows.append({"name": "process_name", "ph": "M", "pid": pid, "args": {"name": pname}})
    for name, tid, ts, args in events:
        rows.append({"name": name, "ph": "X", "pid": pid, "tid": tid, "ts": ts, "dur": 10.0,
                     "cat": "span", "args": args})
    return {"traceEvents": rows}


_HOST_SPANS = r"""
import sys
from slate_tpu_torch.aux import spans
trace = sys.argv[2]
root = spans.start("request", trace=trace, lane="host")
spans.end(spans.start("execute", trace=trace, parent=root, lane="host"))
spans.end(root)
spans.end(spans.start("local", trace=spans.new_trace(), lane="host"))
print(spans.export_chrome(sys.argv[1], process_name="host0"))
"""


class TestTraceStitch:
    def test_port_dumps_join_with_no_orphans(self, tmp_path):
        """The router's half exported here, the host's half by another
        process of the port (spans on from SLATE_TPU_TRACE_RING), joined on
        the router's trace id: one cross-process chain, no orphan."""
        spans.on(ring=1024)
        trace = spans.new_trace()
        root = spans.start("request", trace=trace, lane="router")
        spans.end(spans.start("dispatch", trace=trace, parent=root, lane="host0"))
        spans.end(root)
        rp = spans.export_chrome(str(tmp_path / "router.trace.json"), process_name="router")
        hp = str(tmp_path / "host0.trace.json")
        env = dict(os.environ, SLATE_TPU_TRACE_RING="256", PYTHONPATH=_REPO)
        subprocess.run([sys.executable, "-c", _HOST_SPANS, hp, trace], env=env, check=True,
                       capture_output=True, timeout=120)
        out = tmp_path / "stitched.json"
        res = _run_tool("trace_stitch.py", rp, hp, "-o", str(out))
        assert res.returncode == 0, res.stdout + res.stderr
        assert "cross=1 orphans=0" in res.stdout
        doc = json.loads(out.read_text())
        names = {e["args"]["name"] for e in doc["traceEvents"] if e.get("name") == "process_name"}
        assert names == {"router", "host0"}
        pids = {e["pid"] for e in doc["traceEvents"] if e.get("ph") == "X"}
        assert len(pids) == 2

    def test_joined_chain_namespaces_span_ids(self, tmp_path):
        router = _chrome(100, [("request", 0, 0.0, {"span": 1, "trace": "t64-1"}),
                               ("dispatch", 1, 2.0, {"span": 2, "parent": 1, "trace": "t64-1"})],
                         pname="router")
        host = _chrome(200, [("request", 0, 0.0, {"span": 1, "trace": "t64-1"}),
                             ("execute", 1, 1.0, {"span": 2, "parent": 1, "trace": "t64-1"})],
                       pname="host0")
        rp, hp = tmp_path / "r.json", tmp_path / "h.json"
        rp.write_text(json.dumps(router))
        hp.write_text(json.dumps(host))
        out = tmp_path / "stitched.json"
        res = _run_tool("trace_stitch.py", str(rp), str(hp), "-o", str(out))
        assert res.returncode == 0, res.stdout + res.stderr
        assert "cross=1 orphans=0" in res.stdout
        doc = json.loads(out.read_text())
        sids = {e["args"]["span"] for e in doc["traceEvents"] if e.get("ph") == "X"}
        assert sids == {"100:1", "100:2", "200:1", "200:2"}

    def test_orphan_chain_flags_nonzero(self, tmp_path):
        # a port host's span under a trace minted by a process with no file
        spans.on(ring=64)
        spans.end(spans.start("request", trace="t3e7-9", lane="host"))
        hp = spans.export_chrome(str(tmp_path / "h.json"), process_name="host0")
        res = _run_tool("trace_stitch.py", hp)
        assert res.returncode == 2
        assert "orphans=1" in res.stdout
        assert _run_tool("trace_stitch.py", hp, "--allow-orphans").returncode == 0

    def test_pid_collision_rekeyed(self, tmp_path):
        a = _chrome(100, [("x", 0, 0.0, {"span": 1, "trace": "t64-1"})])
        b = _chrome(100, [("y", 0, 0.0, {"span": 1, "trace": "t64-2"})])
        ap, bp = tmp_path / "a.json", tmp_path / "b.json"
        ap.write_text(json.dumps(a))
        bp.write_text(json.dumps(b))
        out = tmp_path / "s.json"
        res = _run_tool("trace_stitch.py", str(ap), str(bp), "-o", str(out), "--allow-orphans")
        assert res.returncode == 0
        doc = json.loads(out.read_text())
        assert len({e["pid"] for e in doc["traceEvents"]}) == 2


def _dump_counters(path, counters, gauges=()):
    metrics.reset()
    for k, v in counters.items():
        metrics.inc(k, v)
    for k, v in gauges:
        metrics.gauge(k, v)
    return metrics.dump(str(path))


class TestMetricsMergeTag:
    def test_tagged_rows_precede_preserved_globals(self, tmp_path):
        ap = _dump_counters(tmp_path / "a.jsonl", {"fleet.delivered": 5}, [("g", 1)])
        bp = _dump_counters(tmp_path / "b.jsonl", {"fleet.delivered": 3}, [("g", 9)])
        res = _run_tool("metrics_merge.py", "--tag", "host0", "--tag", "host1", ap, bp)
        assert res.returncode == 0, res.stderr
        rows = [json.loads(x) for x in res.stdout.splitlines()]
        tagged = [r for r in rows if "src" in r]
        plain = [r for r in rows if "src" not in r and r["type"] == "counter"]
        assert {(r["name"], r["src"], r["value"]) for r in tagged if r["type"] == "counter"} == {
            ("fleet.delivered", "host0", 5), ("fleet.delivered", "host1", 3)}
        assert [(r["name"], r["value"]) for r in plain] == [("fleet.delivered", 8.0)]
        # tagged rows come first, so last-wins loaders land on globals
        assert rows.index(tagged[0]) < rows.index(plain[0])

    def test_tag_count_mismatch_fails(self, tmp_path):
        ap = _dump_counters(tmp_path / "a.jsonl", {})
        res = _run_tool("metrics_merge.py", "--tag", "x", "--tag", "y", ap)
        assert res.returncode != 0
        assert "pair positionally" in res.stderr

    def test_untagged_output_unchanged(self, tmp_path):
        ap = _dump_counters(tmp_path / "a.jsonl", {"c": 1})
        res = _run_tool("metrics_merge.py", ap)
        rows = [json.loads(x) for x in res.stdout.splitlines()]
        assert all("src" not in r for r in rows if r["type"] != "timeline")


class TestFleetReport:
    def _base(self, **over):
        rows = {"fleet.submitted": 10, "fleet.delivered": 8, "fleet.typed_errors": 2,
                "fleet.bad_results": 0}
        rows.update(over)
        return rows

    def _report(self, tmp_path, counters, *args, gauges=(), hists=()):
        metrics.reset()
        for k, v in counters.items():
            if v:
                metrics.inc(k, v)
        for k, v in gauges:
            metrics.gauge(k, v)
        for k, xs in hists:
            for x in xs:
                metrics.observe_hist(k, x)
        return _run_tool("fleet_report.py", metrics.dump(str(tmp_path / "m.jsonl")), *args)

    def test_reconciled_run_passes(self, tmp_path):
        res = self._report(tmp_path, self._base(), "--require-stitch",
                           gauges=[("fleet.trace_orphans", 0)])
        assert res.returncode == 0, res.stdout

    def test_hung_future_fails(self, tmp_path):
        res = self._report(tmp_path, self._base(**{"fleet.delivered": 7}))
        assert res.returncode == 1
        assert "FAIL  no hung futures" in res.stdout

    def test_bad_result_fails(self, tmp_path):
        trouter.note_bad_result()
        res = self._report(tmp_path, self._base(**{"fleet.bad_results": 1}))
        assert res.returncode == 1
        assert "FAIL  no silent wrong answers" in res.stdout

    def test_sdc_without_recovery_fails(self, tmp_path):
        res = self._report(tmp_path, self._base(**{
            "faults.injected.sdc_solve": 3, "fleet.cert.fail": 2, "fleet.quarantined": 1,
            "fleet.unquarantined": 0}))
        assert res.returncode == 1
        assert "FAIL  sdc quarantined + probe-recovered" in res.stdout

    def test_victim_p99_judged_from_tenant_hist(self, tmp_path):
        over = self._base(**{"fleet.rejected_quota": 4})
        hist = [("fleet.latency.tenant.v.total", [0.01, 0.02, 0.03, 0.04, 0.05])]
        res = self._report(tmp_path, over, "--victim", "v", "--p99-budget", "1.0", hists=hist)
        assert res.returncode == 0, res.stdout
        res = self._report(tmp_path, over, "--victim", "v", "--p99-budget", "0.001", hists=hist)
        assert res.returncode == 1

    def test_missing_stitch_gauge_fails_when_required(self, tmp_path):
        res = self._report(tmp_path, self._base(), "--require-stitch")
        assert res.returncode == 1
        assert "gauge missing" in res.stdout

    def test_non_fleet_jsonl_refused(self, tmp_path):
        res = self._report(tmp_path, {"serve.dispatches": 1})
        assert res.returncode == 2

    def test_orphan_gauge_from_note_trace_orphans(self, tmp_path):
        metrics.reset()
        for k, v in self._base().items():
            if v:
                metrics.inc(k, v)
        trouter.note_trace_orphans(2)
        res = _run_tool("fleet_report.py", metrics.dump(str(tmp_path / "m.jsonl")))
        assert res.returncode == 1 and "trace_orphans=2" in res.stdout


# ---------------------------------------------------------------------------
# serve.api wiring and the spans variable
# ---------------------------------------------------------------------------


def _py(code, **env_over):
    env = dict(os.environ, PYTHONPATH=_REPO)
    for k, v in env_over.items():
        if v is None:
            env.pop(k, None)
        else:
            env[k] = v
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=_REPO, timeout=120)


class TestApiWiring:
    def test_fleet_off_is_none_branch(self):
        out = _py("import sys; from slate_tpu_torch.serve import api; from slate_tpu_torch "
                  "import serve; print(api._fleet, serve.get_fleet(), "
                  "any(m.startswith('slate_tpu_torch.fleet') for m in sys.modules))",
                  SLATE_TPU_FLEET=None)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["None", "None", "False"]

    def test_fleet_env_builds_router_at_import(self):
        out = _py("from slate_tpu_torch.serve import api; "
                  "print(type(api._fleet).__name__, api._fleet.spawn, "
                  "api._fleet.policy.describe(), api.get_fleet() is api._fleet)",
                  SLATE_TPU_FLEET="spawn=2,cert=full")
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["FleetRouter", "2", "full", "True"]

    def test_submit_health_shutdown_route_through_the_router(self, monkeypatch):
        from slate_tpu_torch.serve import api

        calls = []

        class Fake:
            def submit(self, *a, **kw):
                calls.append(("submit", a[0], kw["tenant"]))
                f = Future()
                f.set_result(np.ones((2, 1)))
                return f

            def health(self):
                calls.append(("health",))
                return {"hosts": {}}

            def stop(self, drain=True):
                calls.append(("stop", drain))

        monkeypatch.setattr(api, "_fleet", Fake())
        monkeypatch.setattr(api, "_service", None)
        assert api.gesv(np.eye(2), np.ones((2, 1)), tenant="a").shape == (2, 1)
        assert api.health() == {"hosts": {}}
        api.shutdown()
        assert calls == [("submit", "gesv", "a"), ("health",), ("stop", True)]
        assert api._service is None  # no process service was built


@pytest.mark.parametrize("value,want", [("77", "True 77"), ("0", "False 4096"), ("", "False 4096")])
def test_trace_ring_variable_turns_spans_on(value, want):
    """SLATE_TPU_TRACE_RING=N switches the port's spans on at import with a
    ring of N (how a fleet worker traces); 0 or empty leaves them off."""
    out = _py("from slate_tpu_torch.aux import spans; print(spans.is_on(), spans.capacity())",
              SLATE_TPU_TRACE_RING=value)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == want


def test_trace_ring_variable_not_an_integer_raises():
    out = _py("import slate_tpu_torch.aux.spans", SLATE_TPU_TRACE_RING="lots")
    assert out.returncode != 0
    assert "SLATE_TPU_TRACE_RING='lots': expected an integer ring size" in out.stderr


# ---------------------------------------------------------------------------
# spawned workers end to end
# ---------------------------------------------------------------------------


class TestEndToEnd:
    def test_spawned_worker_solves_and_drains(self):
        r = FleetRouter(spawn=1, cert="full", heartbeat_s=0.3, rpc_timeout_s=60,
                        spawn_env=CPU_WORKER)
        r.start()
        try:
            rng = np.random.default_rng(0)
            A = (rng.standard_normal((8, 8)) + 8 * np.eye(8)).astype(np.float32)
            B = rng.standard_normal((8, 2)).astype(np.float32)
            for f in [r.submit("gesv", A, B, deadline=90.0) for _ in range(3)]:
                X = f.result(timeout=120)
                assert np.max(np.abs(A @ X - B)) < 1e-3
            assert _counter("fleet.delivered") == 3
            assert _counter("fleet.cert.checked") == 3
        finally:
            r.stop(drain=True)
        # drained, reaped: the worker process is gone
        with r._lock:
            procs = [h.proc for h in r._hosts.values()]
        assert all(p.poll() is not None for p in procs)

    def test_worker_without_a_device_fails_typed(self):
        """No device variable and no CUDA: the worker's service cannot be
        built, so its requests fail typed (it never serves on the CPU on
        its own) while the host stays up."""
        env = dict(CPU_WORKER, **{DEVICE_ENV: None, "CUDA_VISIBLE_DEVICES": ""})
        r = FleetRouter(spawn=1, cert="full", heartbeat_s=0.3, rpc_timeout_s=60,
                        spawn_env=env)
        r.start()
        try:
            with pytest.raises(DistributedException, match="no CUDA device"):
                r.submit("gesv", np.eye(4), np.ones((4, 1))).result(timeout=120)
            time.sleep(0.7)  # heartbeats answered (typed): the host stays live
            assert r.health()["hosts"]["0"]["state"] == HOST_LIVE
        finally:
            r.stop(drain=True)

    @pytest.mark.slow
    def test_sigkill_mid_stream_every_future_resolves(self):
        r = FleetRouter(spawn=2, cert="sample=0.25", heartbeat_s=0.2, rpc_timeout_s=60,
                        dead_after=2, respawn=True, spawn_env=CPU_WORKER)
        r.start()
        try:
            rng = np.random.default_rng(0)
            A = (rng.standard_normal((16, 16)) + 16 * np.eye(16)).astype(np.float32)
            B = rng.standard_normal((16, 2)).astype(np.float32)
            for f in [r.submit("gesv", A, B, deadline=90.0) for _ in range(4)]:
                f.result(timeout=120)
            futs = [r.submit("gesv", A, B, deadline=90.0) for _ in range(8)]
            with r._lock:
                proc = r._hosts["0"].proc
            proc.kill()
            for f in futs:
                X = f.result(timeout=120)  # value or typed, never hung
                assert np.max(np.abs(A @ X - B)) < 1e-3
            deadline = time.time() + 60
            state = None
            while time.time() < deadline:
                state = r.health()["hosts"]["0"]["state"]
                if state in ("live", "rejoined"):
                    break
                time.sleep(0.3)
            assert state in ("live", "rejoined")
            assert _counter("fleet.host_dead") >= 1
            assert _counter("fleet.redispatched") >= 1
            assert _counter("fleet.host_respawned") >= 1
        finally:
            r.stop(drain=True)


@pytest.fixture(scope="module")
def cpu_fleet():
    """One spawned port worker on the CPU behind a certifying router."""
    r = FleetRouter(spawn=1, cert="full", heartbeat_s=0.5, rpc_timeout_s=120,
                    spawn_env=CPU_WORKER)
    r.start()
    yield r
    r.stop(drain=True)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("routine", ["gesv", "posv"])
def test_spawned_worker_x_matches_jax_and_numpy(cpu_fleet, grid11, routine, dtype):
    """A spawned port worker's X at n = 32 against ``slate_tpu.gesv`` /
    ``posv`` and numpy on the same seeded inputs, within 50 n eps
    max|ref|; the router certified it."""
    n, nrhs = 32, 3
    rng = np.random.default_rng(32)
    G = rng.standard_normal((n, n))
    A = (G @ G.T + n * np.eye(n)) if routine == "posv" else G + 2 * np.sqrt(n) * np.eye(n)
    A, B = A.astype(dtype), rng.standard_normal((n, nrhs)).astype(dtype)
    X = cpu_fleet.submit(routine, A, B, deadline=120.0).result(timeout=180)
    assert X.dtype == dtype and X.shape == (n, nrhs)
    JA = (st.HermitianMatrix if routine == "posv" else st.Matrix).from_global(
        jnp.asarray(A), 8, grid=grid11)
    JX = getattr(st, routine)(JA, st.Matrix.from_global(jnp.asarray(B), 8, grid=grid11))[0]
    jx = np.asarray(JX.to_global())
    ref = np.linalg.solve(A.astype(np.float64), B.astype(np.float64))
    tol = 50 * n * np.finfo(dtype).eps * np.abs(ref).max()
    assert np.abs(X - jx).max() <= tol
    assert np.abs(X - ref).max() <= tol


# ---------------------------------------------------------------------------
# the JAX fleet drill and its escape leg on two spawned CPU workers
# ---------------------------------------------------------------------------


def test_fleet_drill_and_escape_leg_on_cpu_workers(capsys):
    """``chip_smoke.py`` phase 22 legs (a) and (b) with CPU workers (the
    device variable in each spawn environment): ``run_tests.py``'s fleet
    drill as written in a fresh interpreter under SLATE_TPU_SYNC_CHECK=1,
    judged by tools/fleet_report.py with the gate's arguments (exit 0),
    then the escape leg (cert off: wrong X delivered, exit != 0); no sync
    violation, no JAX module in the router's process."""
    sys.path.insert(0, _REPO)
    import chip_smoke as cs

    gate = cs._Gate22(torch.device("cpu"))
    try:
        got = gate.finish()
    finally:
        gate.close()
    assert got["drill_report_rc"] == 0 and got["escape_report_rc"] != 0
    assert got["violations"] == [] and got["escape"]["bad"] > 0
    c = got["drill"]["counters"]
    assert c["fleet.submitted"] == c["fleet.delivered"] + c.get("fleet.typed_errors", 0)
    for k in ("fleet.quarantined", "fleet.unquarantined", "fleet.host_dead",
              "fleet.host_respawned", "fleet.host_rejoined", "fleet.rejected_quota",
              "fleet.rpc_retries", "fleet.redispatched"):
        assert c.get(k, 0) >= 1, (k, c)
    assert "orphans=0" in got["drill"]["stitch"]
