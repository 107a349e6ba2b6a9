"""One fleet host: a socket front-end over this process's
:class:`~slate_tpu_torch.serve.service.SolverService` (the JAX package's
``fleet/worker.py``).

Runnable as ``python -m slate_tpu_torch.fleet.worker [--port N]``.  The
worker binds (``SLATE_TPU_FLEET_ADDR``, default loopback), announces
``FLEET_WORKER_PORT=<port>`` on stdout (how the router's ``spawn=`` mode
learns an ephemeral port) before it touches the service, and serves one
RPC per connection, thread-per-connection: the service underneath does
the real concurrency, a handler thread just parks in ``Future.result()``.

The service is the process-wide one of ``serve.api``, built at the first
request: on ``cuda:0`` through the default placement (which raises
without CUDA), or on the device ``SLATE_TPU_FLEET_DEVICE`` names (``cpu``,
``cuda:1``, ...; read only by :func:`main`, an unknown value raises).  A
worker never moves to the CPU on its own: a spawned CPU worker is asked
for in its spawn environment.

Ops (``header["op"]``):

* ``solve`` -- arrays A, B + routine/deadline/retries/precision/tenant/
  priority/trace.  Runs ``service.submit(...).result()`` and replies
  ``{"ok": True}`` + X, or ``{"ok": False, "error": <class>, "message":
  ..., "context": {...}}`` for typed failures: the error taxonomy crosses
  the wire by name, so the router re-raises the class the single-process
  path would.  The router's trace id is adopted via ``submit(trace_id=)``:
  this host's spans join the router's chain and ``tools/trace_stitch.py``
  renders one request as one cross-process track.
* ``report`` -- heartbeat + stats: queue depth, inflight, phase, the local
  admission plane's burn EWMA (None when the plane is off).  Before the
  first request has built the service it answers ``phase: "cold"`` and
  builds nothing: a heartbeat must not wait on a CUDA context.
* ``dump`` -- write this process's metrics JSONL and span ring to the
  paths the router names (host-tagged observability fan-in).
* ``drain`` -- ``service.stop(drain=True)``: admission closes now,
  admitted work finishes, then the process exits.
* ``ping`` -- liveness only.

The worker has no fleet-specific defense logic: quotas, quarantine,
hedging and host lifecycle live at the router, so a host's failure modes
stay the service's own (plus death, which the router owns).
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import threading
import time
from typing import Optional

import torch

from ..aux import metrics, spans
from ..exceptions import SlateError
from . import wire

#: worker bind address (the router address knob's worker half); spawned
#: workers inherit it from the router's environment
ADDR_ENV = "SLATE_TPU_FLEET_ADDR"

#: the device a worker serves on when its environment names one (the CPU
#: tests' spawn environments carry ``cpu``); unset: ``cuda:0``
DEVICE_ENV = "SLATE_TPU_FLEET_DEVICE"

#: stdout announce line prefix (the spawn handshake contract)
ANNOUNCE = "FLEET_WORKER_PORT="

#: idle-connection bound: a peer that opens a socket and never sends a
#: full frame must not pin a handler thread forever
IDLE_TIMEOUT_S = 120.0


def device_from_env() -> Optional[torch.device]:
    """The device ``SLATE_TPU_FLEET_DEVICE`` names, or None when unset."""
    v = os.environ.get(DEVICE_ENV, "").strip()
    if not v:
        return None
    try:
        dev = torch.device(v)
    except RuntimeError as e:
        raise ValueError(f"{DEVICE_ENV}={v!r}: not a device") from e
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{DEVICE_ENV}={v!r}: expected cpu or cuda[:i]")
    return dev


class FleetWorker:
    """Socket front-end over one process-wide serve service."""

    def __init__(self, host: Optional[str] = None, port: int = 0, service=None,
                 device: Optional[torch.device] = None):
        self.host = host or os.environ.get(ADDR_ENV) or "127.0.0.1"
        self.port = int(port)
        self.device = device
        self._service = service
        self._service_lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()

    @property
    def service(self):
        # lazy: building the service (and a CUDA context) happens on first
        # use, not at construction, and never before the announce line
        if self._service is None:
            with self._service_lock:
                if self._service is None:
                    from ..serve import api as serve_api

                    if self.device is None:
                        self._service = serve_api.get_service()
                    else:
                        from ..serve.placement import PlacementPolicy

                        self._service = serve_api.configure(
                            placement=PlacementPolicy(devices=[self.device]))
        return self._service

    # -- serving ------------------------------------------------------------

    def bind(self) -> int:
        """Bind + listen; returns the (possibly ephemeral) port."""
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(64)
        self._sock = s
        self.port = s.getsockname()[1]
        return self.port

    def serve_forever(self, announce: bool = True) -> None:
        if self._sock is None:
            self.bind()
        if announce:
            print(f"{ANNOUNCE}{self.port}", flush=True)
        self._sock.settimeout(0.25)  # poll the stop flag
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener closed under us (drain)
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()
        self._sock.close()

    def shutdown(self) -> None:
        self._stop.set()

    # -- one RPC ------------------------------------------------------------

    def _handle(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(IDLE_TIMEOUT_S)
            header, arrays = wire.recv_msg(conn)
            op = header.get("op")
            try:
                reply, out = self._op(op, header, arrays)
            except Exception as e:  # noqa: BLE001 -- e.g. no service without a device
                # answered typed: the host stays up, its failure is the op's
                reply, out = {"ok": False, "error": type(e).__name__, "message": str(e)}, {}
            wire.send_msg(conn, reply, out)
            if op == "drain":
                # reply first (the router is waiting on it), then stop:
                # admission closes immediately, admitted work finishes
                self._drain_and_exit(header)
        except (ConnectionError, OSError, wire.ProtocolError):
            pass  # peer vanished mid-frame; nothing to answer
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _op(self, op, header: dict, arrays: dict):
        if op == "solve":
            return self._solve(header, arrays)
        if op == "report":
            return self._report(), {}
        if op == "dump":
            return self._dump(header), {}
        if op in ("drain", "ping"):
            return {"ok": True, "op": op}, {}
        return {"ok": False, "error": "ProtocolError", "message": f"unknown fleet op {op!r}"}, {}

    def _solve(self, header: dict, arrays: dict):
        deadline = header.get("deadline")
        if deadline is not None:
            # the router ships the REMAINING budget: rebase on this host's
            # clock (wall-clock offsets between processes cancel out)
            deadline = max(0.0, float(deadline))
        try:
            fut = self.service.submit(
                header["routine"], arrays["A"], arrays["B"], deadline=deadline,
                retries=int(header.get("retries", 0)), precision=header.get("precision"),
                tenant=header.get("tenant"), priority=header.get("priority"),
                trace_id=header.get("trace"))
            X = fut.result()
        except Exception as e:  # typed taxonomy crosses by name
            metrics.inc("fleet.worker.typed_errors")
            reply = {"ok": False, "error": type(e).__name__,
                     "message": str(e.args[0]) if e.args else str(e)}
            if isinstance(e, SlateError):
                reply["context"] = e.context()
            return reply, {}
        metrics.inc("fleet.worker.solved")
        return {"ok": True, "op": "solve"}, {"X": X}

    def _report(self) -> dict:
        # a report never builds the service: that (a CUDA context, the
        # first request's work) takes seconds, past a heartbeat's bound,
        # and a host that is still building is alive
        svc = self._service
        h = {"phase": "cold"} if svc is None else svc.health()
        adm = h.get("admission") or {}
        return {
            "ok": True,
            "op": "report",
            "pid": os.getpid(),
            "phase": h.get("phase"),
            "queue_depth": int(h.get("queue_depth", 0)),
            "inflight": int(h.get("inflight", 0)),
            "burn": adm.get("burn_ewma"),
            "t": time.time(),
        }

    def _dump(self, header: dict) -> dict:
        out = {"ok": True, "op": "dump", "metrics": None, "trace": None}
        mpath = header.get("metrics")
        if mpath and metrics.is_on():
            out["metrics"] = metrics.dump(mpath)
        tpath = header.get("trace")
        if tpath and spans.is_on():
            out["trace"] = spans.export_chrome(tpath, process_name=header.get("label"))
        return out

    def _drain_and_exit(self, header: dict) -> None:
        self.shutdown()
        svc = self._service
        if svc is not None:
            svc.stop(drain=True, drain_timeout=float(header.get("timeout", 10.0)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="slate_tpu_torch fleet worker (one host process)")
    ap.add_argument("--host", default=None, help="bind address")
    ap.add_argument("--port", type=int, default=0,
                    help="bind port (0 = ephemeral, announced on stdout)")
    args = ap.parse_args(argv)
    w = FleetWorker(host=args.host, port=args.port, device=device_from_env())
    w.bind()
    w.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
