"""The fleet tier: a least-loaded router over N worker processes that
extends every single-process defense plane across the process
boundary (the JAX package's ``fleet/router.py``).

``FleetRouter`` fronts workers (spawned subprocesses or pre-started
``connect=`` addresses) behind the same ``submit()/health()/stop()``
surface as :class:`~slate_tpu_torch.serve.service.SolverService`, speaking
the length-prefixed RPC in :mod:`slate_tpu_torch.fleet.wire`.  The planes it
adds on top — and where each reuses the single-process machinery:

* **Global admission** — ONE :class:`~slate_tpu_torch.serve.admission.
  AdmissionControl` lives at the router (its token buckets tick on the
  router's monotonic clock), so a tenant's quota is fleet-wide: an
  abuser refused here never reaches any host, instead of getting a
  fresh bucket per process.  Worker heartbeat reports carry each
  host's local burn EWMA; the router folds them into its own overload
  controller (``observe_burn``) beside the burn it measures directly
  on deliveries, so sustained overload anywhere sheds fleet-wide,
  lowest priority first.
* **Host lifecycle** — breaker-shaped states per host: ``live`` →
  (one RPC/heartbeat failure) → ``suspect`` → (``dead_after``
  consecutive failures) → ``dead`` → (a heartbeat answered again) →
  ``rejoined`` → (first certified delivery) → ``live``.  Inflight
  requests on a host that dies are failed fast and re-dispatched to a
  live host within a counted budget (``fleet.redispatched``); RPC
  timeouts retry with ``decorrelated_backoff`` jitter
  (``fleet.rpc_retries``).  Late stat reports from a host marked dead
  update stats only — state transitions flow ONLY through the
  heartbeat/failure paths, so a stale report cannot resurrect a dead
  host.  ``stop(drain=True)`` closes admission immediately, lets
  admitted work finish (re-dispatches included), resolves any
  leftovers typed, then drains each host through the worker's
  ``stop(drain=True)`` path.
* **Cross-host hedging + SDC quarantine** — deliveries are certified
  at the router with the factor-cache residual fence
  (:func:`~slate_tpu_torch.integrity.policy.residual_certificate`), sampled
  per an :class:`~slate_tpu_torch.integrity.policy.IntegrityPolicy`; a
  failed certificate re-executes on a *different* host.  Per-host
  :class:`~slate_tpu_torch.integrity.policy.IntegrityScore` aggregation
  quarantines a whole host (excluded from dispatch while cooling
  down) and probe-recovers it: a rejoined/quarantined host's next
  delivery is certified regardless of the sampling rate.  Stragglers
  older than ``hedge_s`` are cloned onto a different host; the first
  member to deliver wins, exactly once.
* **Stitched observability** — the router mints the trace id, workers
  adopt it via ``submit(trace_id=)``, and per-host ``dump`` RPCs +
  ``tools/trace_stitch.py`` / ``tools/metrics_merge.py --tag`` join
  the pieces back into one fleet-wide view.

Configuration (``SLATE_TPU_FLEET`` or constructor args)::

    spawn=2                       # spawn N local worker processes
    connect=127.0.0.1:7701+...    # or join pre-started workers
    cert=0.25 | cert=full | cert=off    # router-side certification
    hedge=0.5                     # straggler hedge age, s (0 = off)
    retries=2                     # transient RPC retries per dispatch
    redispatch=2                  # cross-host re-dispatch budget
    dead_after=3                  # consecutive failures -> dead
    threshold=0.6,cooldown=2.0,alpha=0.5   # host quarantine knobs
    respawn                       # respawn spawned workers that die
    seed=0

plus ``SLATE_TPU_FLEET_TENANTS`` (the ``admission.parse_tenants``
grammar, applied fleet-wide), ``SLATE_TPU_FLEET_HEARTBEAT`` (period,
s) and ``SLATE_TPU_FLEET_TIMEOUT`` (per-RPC bound, s).

Zero overhead off: with no fleet configured, ``serve.api`` never
constructs this class and single-process serving is byte-identical
(one ``is None`` branch at submit).
"""

from __future__ import annotations

import os
import random
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..aux import faults, metrics, spans, sync
from ..exceptions import NumericalError, SlateError
from ..integrity.policy import IntegrityScore, parse_spec as parse_integrity
from ..serve import admission as _adm
from ..serve.service import (
    Rejected,
    Shed,
    decorrelated_backoff,
)
from . import wire
from .worker import ADDR_ENV, ANNOUNCE

FLEET_ENV = "SLATE_TPU_FLEET"
FLEET_TENANTS_ENV = "SLATE_TPU_FLEET_TENANTS"
HEARTBEAT_ENV = "SLATE_TPU_FLEET_HEARTBEAT"
TIMEOUT_ENV = "SLATE_TPU_FLEET_TIMEOUT"

#: breaker-shaped host states (health()["hosts"] vocabulary)
HOST_LIVE = "live"
HOST_SUSPECT = "suspect"
HOST_DEAD = "dead"
HOST_REJOINED = "rejoined"

#: first backoff step for transient-RPC retry jitter, seconds
RPC_BACKOFF_BASE_S = 0.05

#: how long a spawned worker gets to announce its port, seconds (the
#: torch import dominates; the worker announces before it builds its
#: service or touches the card)
SPAWN_ANNOUNCE_TIMEOUT_S = 90.0


class FleetError(SlateError):
    """Fleet-tier failure (RPC, routing, drain) — typed so a client
    can distinguish fabric trouble from numerical/admission errors."""


class HostDead(FleetError):
    """The request's host died (or no live host remains) and the
    re-dispatch budget is exhausted — fail-fast, never a hang."""


class FleetTimeout(FleetError):
    """An RPC exceeded its bound after transient retries."""


def note_bad_result(n: int = 1) -> None:
    """Count a client-verified wrong answer (``fleet.bad_results``) —
    the fleet drill's reference checks report through here so the
    counter has one in-library spelling for ``fleet_report`` to join
    (zero silent wrong answers is the gate's core claim)."""
    metrics.inc("fleet.bad_results", n)


def note_trace_orphans(n: int) -> None:
    """Record the stitched-trace orphan count (``fleet.trace_orphans``
    gauge) — set by the drill from ``tools/trace_stitch.py`` output."""
    metrics.gauge("fleet.trace_orphans", n)


# ---------------------------------------------------------------------------
# spec parsing
# ---------------------------------------------------------------------------


def parse_fleet(spec: str) -> dict:
    """``SLATE_TPU_FLEET`` grammar -> FleetRouter kwargs (module
    docstring).  Malformed specs fail naming the knob."""
    kw: dict = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        k, sep, v = item.partition("=")
        if k == "spawn" and sep:
            kw["spawn"] = int(v)
        elif k == "connect" and sep:
            addrs = []
            for a in v.split("+"):
                host, _, port = a.rpartition(":")
                addrs.append((host or "127.0.0.1", int(port)))
            kw["connect"] = tuple(addrs)
        elif k == "cert" and sep:
            kw["cert"] = (
                v if v in ("full", "off") or v.startswith("sample=")
                else f"sample={float(v)}"
            )
        elif k == "hedge" and sep:
            kw["hedge_s"] = float(v)
        elif k == "retries" and sep:
            kw["rpc_retries"] = int(v)
        elif k == "redispatch" and sep:
            kw["redispatch_max"] = int(v)
        elif k == "dead_after" and sep:
            kw["dead_after"] = int(v)
        elif k == "threshold" and sep:
            kw["quarantine_threshold"] = float(v)
        elif k == "cooldown" and sep:
            kw["quarantine_cooldown_s"] = float(v)
        elif k == "alpha" and sep:
            kw["quarantine_alpha"] = float(v)
        elif k == "seed" and sep:
            kw["seed"] = int(v)
        elif k == "respawn" and not sep:
            kw["respawn"] = True
        else:
            raise ValueError(
                f"{FLEET_ENV}={spec!r}: unknown key {item!r} "
                "(spawn=|connect=|cert=|hedge=|retries=|redispatch=|"
                "dead_after=|threshold=|cooldown=|alpha=|seed=|respawn)"
            )
    if not kw.get("spawn") and not kw.get("connect"):
        raise ValueError(
            f"{FLEET_ENV}={spec!r}: need spawn=<n> or connect=<addrs>"
        )
    return kw


# ---------------------------------------------------------------------------
# host + request records
# ---------------------------------------------------------------------------


class _Host:
    """One worker process as the router sees it.  All mutable fields
    advance under the router's ``_lock`` except ``score``, which is
    self-locked (IntegrityScore)."""

    __slots__ = (
        "name", "addr", "proc", "spawn_env", "state", "fails",
        "inflight", "queue_depth", "burn", "probe_pending",
        "last_report", "died_at", "score",
    )

    def __init__(self, name: str, addr: Tuple[str, int],
                 proc=None, spawn_env=None, score: IntegrityScore = None):
        self.name = name
        self.addr = addr
        self.proc = proc  # guarded by: _lock (external)
        self.spawn_env = spawn_env
        self.state = HOST_LIVE  # guarded by: _lock (external)
        self.fails = 0  # consecutive  # guarded by: _lock (external)
        self.inflight = 0  # guarded by: _lock (external)
        self.queue_depth = 0  # guarded by: _lock (external)
        self.burn = None  # guarded by: _lock (external)
        self.probe_pending = False  # guarded by: _lock (external)
        self.last_report = 0.0  # guarded by: _lock (external)
        self.died_at = 0.0  # guarded by: _lock (external)
        self.score = score if score is not None else IntegrityScore()


class _FleetRequest:
    """One client submit: future + dispatch bookkeeping.  Mutable
    fields advance under the router's ``_lock``; the future resolves
    outside it, exactly once (``done`` is the gate)."""

    __slots__ = (
        "rid", "routine", "A", "B", "deadline_s", "t_deadline",
        "retries", "precision", "tenant", "prio", "future", "trace",
        "root", "t_submit", "attempts", "hedged", "settled",
        "members",
        "hosts_tried",
    )

    def __init__(self, rid, routine, A, B, deadline_s, retries,
                 precision, tenant, prio, trace, root, now):
        self.rid = rid
        self.routine = routine
        self.A = A
        self.B = B
        self.deadline_s = deadline_s
        self.t_deadline = (
            now + deadline_s if deadline_s is not None else None
        )
        self.retries = retries
        self.precision = precision
        self.tenant = tenant
        self.prio = prio
        self.future = Future()
        self.trace = trace
        self.root = root
        self.t_submit = now
        self.attempts = 0  # dispatches so far  # guarded by: _lock (external)
        self.hedged = False  # guarded by: _lock (external)
        self.settled = False  # guarded by: _lock (external)
        self.members = []  # every dispatch  # guarded by: _lock (external)
        self.hosts_tried = set()  # guarded by: _lock (external)

    def alive_locked(self, but=None) -> bool:
        """A member other than ``but`` is still running and not yet
        compensated — its outcome will resolve this request, so the
        caller must not."""
        return any(
            m is not but and not m.finished and not m.doomed
            for m in self.members
        )


class _Member:
    """One dispatch of one request onto one host.  ``doomed`` marks a
    member the failure machinery already compensated for (host-death
    fail-fast re-dispatch, typed resolution) — its own eventual RPC
    error must not spend budget again."""

    __slots__ = ("host", "hedge", "doomed", "finished")

    def __init__(self, host: _Host, hedge: bool):
        self.host = host
        self.hedge = hedge
        self.doomed = False  # guarded by: _lock (external)
        self.finished = False  # guarded by: _lock (external)


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


class FleetRouter:
    """Least-loaded cross-process router (module docstring)."""

    def __init__(
        self,
        spawn: int = 0,
        connect: Tuple[Tuple[str, int], ...] = (),
        tenants=None,
        cert: str = "sample=0.25",
        hedge_s: float = 0.0,
        rpc_retries: int = 2,
        redispatch_max: int = 2,
        dead_after: int = 3,
        heartbeat_s: Optional[float] = None,
        rpc_timeout_s: Optional[float] = None,
        quarantine_threshold: float = 0.6,
        quarantine_cooldown_s: float = 2.0,
        quarantine_alpha: float = 0.5,
        respawn: bool = False,
        spawn_env=None,
        seed: int = 0,
        max_dispatch_threads: int = 32,
    ):
        if spawn <= 0 and not connect:
            raise ValueError("FleetRouter needs spawn>0 or connect addrs")
        self.spawn = int(spawn)
        self.connect = tuple(connect)
        self.hedge_s = float(hedge_s)
        self.rpc_retries = int(rpc_retries)
        self.redispatch_max = int(redispatch_max)
        self.dead_after = max(1, int(dead_after))
        self.heartbeat_s = (
            float(heartbeat_s) if heartbeat_s is not None
            else float(os.environ.get(HEARTBEAT_ENV, "") or 0.5)
        )
        self.rpc_timeout_s = (
            float(rpc_timeout_s) if rpc_timeout_s is not None
            else float(os.environ.get(TIMEOUT_ENV, "") or 30.0)
        )
        self.respawn = bool(respawn)
        self.seed = int(seed)
        self._quarantine_kw = dict(
            alpha=float(quarantine_alpha),
            threshold=float(quarantine_threshold),
            cooldown_s=float(quarantine_cooldown_s),
        )
        # router-side certification policy (None = off; the escape
        # leg's disarmed configuration)
        self.policy = parse_integrity(cert)
        self._tenant_keys = None  # lazily a metrics.CappedKeys
        if tenants is None:
            tenants = os.environ.get(FLEET_TENANTS_ENV, "")
        if isinstance(tenants, str):
            tenants = (
                _adm.parse_tenants(tenants) if tenants.strip() else None
            )
        # the GLOBAL admission plane: one instance, the router's clock
        self._admission = (
            _adm.AdmissionControl(tenants=tenants) if tenants else None
        )
        self._spawn_env = spawn_env
        # sync.Lock: plain threading.Lock unless SLATE_TPU_SYNC_CHECK
        # armed the race plane (zero overhead off)
        self._lock = sync.Lock(name="fleet.FleetRouter._lock")
        self._hosts: Dict[str, _Host] = {}  # guarded by: _lock
        self._pending: Dict[int, _FleetRequest] = {}  # guarded by: _lock
        self._rid = 0  # guarded by: _lock
        self._started = False  # guarded by: _lock
        self._draining = False  # guarded by: _lock
        self._stopped = False  # guarded by: _lock
        self._pool: Optional[ThreadPoolExecutor] = None
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        self._max_dispatch_threads = int(max_dispatch_threads)

    @staticmethod
    def from_env() -> Optional["FleetRouter"]:
        """Build from ``SLATE_TPU_FLEET`` (None when unset/empty —
        the zero-overhead-off decision ``serve.api`` branches on)."""
        spec = os.environ.get(FLEET_ENV, "").strip()
        if not spec:
            return None
        return FleetRouter(**parse_fleet(spec))

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "FleetRouter":
        """Spawn/connect the hosts and start the heartbeat (idempotent;
        ``submit`` calls it lazily)."""
        with self._lock:
            if self._started:
                return self
            self._started = True
        for i in range(self.spawn):
            env = self._env_for(i)
            proc, addr = self._spawn_worker(env)
            self._add_host(str(i), addr, proc=proc, spawn_env=env)
        for j, addr in enumerate(self.connect):
            self._add_host(str(self.spawn + j), addr)
        self._pool = ThreadPoolExecutor(
            max_workers=self._max_dispatch_threads,
            thread_name_prefix="fleet-dispatch",
        )
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="fleet-heartbeat",
            daemon=True,
        )
        self._hb_thread.start()
        return self

    def _env_for(self, i: int) -> dict:
        env = dict(os.environ)
        # a worker must never build its own fleet tier (recursion), and
        # its bind address comes from the router's address knob
        env.pop(FLEET_ENV, None)
        env.pop(FLEET_TENANTS_ENV, None)
        env.setdefault(ADDR_ENV, "127.0.0.1")
        overrides = self._spawn_env
        if isinstance(overrides, (list, tuple)):
            overrides = overrides[i] if i < len(overrides) else None
        for k, v in (overrides or {}).items():
            if v is None:
                env.pop(k, None)
            else:
                env[k] = str(v)
        return env

    def _spawn_worker(self, env: dict):
        proc = subprocess.Popen(
            # -c, not -m: runpy would re-execute the worker module as
            # __main__ next to the already-imported copy
            [sys.executable, "-c",
             "import sys; from slate_tpu_torch.fleet.worker import main; "
             "sys.exit(main())"],
            env=env, stdout=subprocess.PIPE, text=True,
        )
        port = None
        deadline = time.monotonic() + SPAWN_ANNOUNCE_TIMEOUT_S
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break  # worker died before announcing
            if line.startswith(ANNOUNCE):
                port = int(line[len(ANNOUNCE):].strip())
                break
        if port is None:
            proc.kill()
            raise FleetError(
                "fleet worker failed to announce a port "
                f"(rc={proc.poll()})"
            )
        # keep draining stdout so the pipe can never block the worker
        threading.Thread(
            target=_drain_pipe, args=(proc.stdout,), daemon=True
        ).start()
        return proc, (env.get(ADDR_ENV, "127.0.0.1"), port)

    def _add_host(self, name, addr, proc=None, spawn_env=None) -> _Host:
        h = _Host(
            name, addr, proc=proc, spawn_env=spawn_env,
            score=IntegrityScore(**self._quarantine_kw),
        )
        with self._lock:
            self._hosts[name] = h
        return h

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the fleet.  ``drain=True``: admission closes NOW
        (submits refuse typed), admitted work — re-dispatches included
        — finishes within ``timeout``, leftovers resolve typed
        (``fleet.drain_abandoned``), then every live host drains via
        its worker's ``stop(drain=True)`` path and spawned processes
        are reaped.  No future ever hangs across a stop."""
        with self._lock:
            if self._stopped:
                return
            self._draining = True
            started = self._started
            self._stopped = not started
        if not started:
            return
        deadline = time.monotonic() + max(0.0, timeout)
        if drain:
            while time.monotonic() < deadline:
                with self._lock:
                    if not self._pending:
                        break
                time.sleep(0.02)
        # resolve anything still inflight typed — bounded, not hung
        with self._lock:
            leftovers = [
                p for p in self._pending.values() if not p.settled
            ]
            for p in leftovers:
                p.settled = True
            self._pending.clear()
            # snapshot state + proc under the lock; after _stopped no
            # path mutates them, so the loop below reads its own copy
            hosts = [
                (h, h.state != HOST_DEAD, h.proc)
                for h in self._hosts.values()
            ]
            self._stopped = True
        for p in leftovers:
            metrics.inc("fleet.drain_abandoned")
            metrics.inc("fleet.typed_errors")
            self._finish_spans(p, "FleetError")
            p.future.set_exception(
                FleetError(
                    "fleet stopped before this request finished"
                ).with_context(routine=p.routine, tenant=p.tenant)
            )
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
        for h, alive, proc in hosts:
            if alive and drain:
                try:
                    self._rpc(h, {"op": "drain", "timeout": 5.0},
                              timeout=10.0, retries=0)
                    metrics.inc("fleet.drained")
                except (OSError, SlateError):
                    pass  # a host that cannot drain gets reaped below
            if proc is not None:
                try:
                    proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=5.0)
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    # -- submit -------------------------------------------------------------

    def submit(
        self,
        routine: str,
        A,
        B,
        deadline: Optional[float] = None,
        retries: int = 0,
        precision: Optional[str] = None,
        sharded: Optional[bool] = None,
        tenant: Optional[str] = None,
        priority=None,
    ) -> Future:
        """Enqueue one solve fleet-wide; returns a Future (same
        contract as ``SolverService.submit``, same typed taxonomy —
        plus :class:`HostDead`/:class:`FleetTimeout` for fabric
        failures).  Global admission runs HERE: quota and shed
        decisions are fleet-wide, on the router's single clock."""
        del sharded  # placement inside each host decides (size-routed)
        self.start()
        tname, prio = _adm.resolve_identity(tenant, priority)
        with self._lock:
            draining = self._draining
        if draining:
            metrics.inc("fleet.refused")
            raise Rejected(
                "fleet is draining — admission closed"
            ).with_context(routine=routine, tenant=tname)
        adm = self._admission
        now = time.monotonic()
        if adm is not None:
            adm.tick(now)
            if adm.sheds(prio):
                adm.tenant_event(tname, "shed")
                metrics.inc("fleet.shed")
                metrics.inc("fleet.refused")
                raise Shed(
                    "fleet overload: priority class refused"
                ).with_context(
                    routine=routine, tenant=tname,
                    priority=_adm.PRIORITIES[prio],
                )
            if not adm.quota_take(tname, now):
                adm.tenant_event(tname, "rejected")
                metrics.inc("fleet.rejected_quota")
                metrics.inc("fleet.refused")
                raise Rejected(
                    f"tenant {tname!r} over fleet-wide quota"
                ).with_context(routine=routine, tenant=tname)
            adm.tenant_event(tname, "admitted")
        A = np.asarray(A)
        B = np.asarray(B)
        if B.ndim == 1:
            B = B[:, None]
        if A.ndim != 2 or B.ndim != 2 or A.shape[0] != B.shape[0]:
            raise ValueError(
                f"{routine}: bad shapes A{A.shape} B{B.shape}"
            )
        metrics.inc("fleet.submitted")
        trace = root = None
        if spans.is_on():
            trace = spans.new_trace()
            root = spans.start(
                "request", trace=trace, lane="router", routine=routine,
            )
        with self._lock:
            self._rid += 1
            p = _FleetRequest(
                self._rid, routine, A, B, deadline, int(retries),
                precision, tname, prio, trace, root, now,
            )
            self._pending[p.rid] = p
            host = self._pick_host_locked(exclude=())
        if host is None:
            self._resolve_exc(
                p,
                HostDead("no live fleet host").with_context(
                    routine=routine, tenant=tname
                ),
            )
        else:
            self._spawn_run(p, host, hedge=False)
        return p.future

    # -- host selection -----------------------------------------------------

    def _pick_host_locked(self, exclude=()) -> Optional[_Host]:
        """Least-loaded eligible host (router inflight + last reported
        queue depth).  Eligible = live/rejoined, not quarantine-
        excluded, not in ``exclude``; when quarantine excludes every
        candidate the least-loaded non-dead host still serves (degraded
        capacity must not become zero capacity)."""
        now = time.monotonic()
        candidates = [
            h for h in self._hosts.values()
            if h.state in (HOST_LIVE, HOST_REJOINED)
            and h.name not in exclude
        ]
        healthy = [h for h in candidates if not h.score.excluded(now)]
        pool = healthy or candidates
        best = None
        best_load = 0
        for h in pool:
            load = h.inflight + h.queue_depth
            if best is None or load < best_load:
                best, best_load = h, load
        return best

    # -- dispatch -----------------------------------------------------------

    def _spawn_run(self, p: _FleetRequest, host: _Host,
                   hedge: bool) -> None:
        m = _Member(host, hedge)
        with self._lock:
            if p.settled:
                return
            p.attempts += 1
            p.members.append(m)
            p.hosts_tried.add(host.name)
            host.inflight += 1
        self._pool.submit(self._run, p, m)

    def _run(self, p: _FleetRequest, m: _Member) -> None:
        host = m.host
        try:
            self._run_inner(p, m)
        except BaseException as e:  # belt: a dispatch thread must
            # never die with the member unaccounted (the future would
            # wait on a ghost member) — resolve through the same path
            self._member_failed(p, m, e)
        finally:
            with self._lock:
                host.inflight = max(0, host.inflight - 1)
                m.finished = True

    def _run_inner(self, p: _FleetRequest, m: _Member) -> None:
        host = m.host
        now = time.monotonic()
        if p.t_deadline is not None and now >= p.t_deadline:
            from ..serve.service import DeadlineExceeded

            self._member_failed(
                p, m,
                DeadlineExceeded(
                    "deadline passed before fleet dispatch"
                ).with_context(routine=p.routine, tenant=p.tenant),
            )
            return
        if faults.is_on() and faults.fire("host_death") is not None:
            # chaos: SIGKILL the worker mid-stream (connect-mode hosts
            # get the router-side signature of the same event)
            with self._lock:
                proc = host.proc
            if proc is not None:
                proc.kill()
            else:
                self._note_host_failure(host, hard=True)
                self._member_failed(
                    p, m, ConnectionError("injected host_death")
                )
                return
        header = {
            "op": "solve",
            "routine": p.routine,
            "retries": p.retries,
            "precision": p.precision,
            "tenant": p.tenant,
            "priority": _adm.PRIORITIES[p.prio],
            "trace": p.trace,
            "deadline": (
                None if p.t_deadline is None
                else max(0.0, p.t_deadline - now)
            ),
        }
        dsp = None
        if spans.is_on():
            dsp = spans.start(
                "dispatch", trace=p.trace, parent=p.root,
                lane=f"host{host.name}", host=host.name, hedge=m.hedge,
            )
        try:
            reply, arrays = self._rpc(
                host, header, {"A": p.A, "B": p.B},
                timeout=self.rpc_timeout_s, retries=self.rpc_retries,
                solve=True,
            )
        except (OSError, SlateError) as e:
            spans.end(dsp, outcome=type(e).__name__)
            self._note_host_failure(host)
            self._member_failed(p, m, e)
            return
        self._note_host_ok(host)
        if not reply.get("ok"):
            spans.end(dsp, outcome=reply.get("error") or "error")
            self._member_typed(p, m, reply)
            return
        X = arrays.get("X")
        if X is None:
            spans.end(dsp, outcome="ProtocolError")
            self._member_failed(
                p, m,
                wire.ProtocolError("solve reply carried no X"),
            )
            return
        verdict = self._certify(p, host, X)
        spans.end(dsp, outcome="ok" if verdict else "cert_fail")
        if not verdict:
            # certified-wrong: never deliver — re-execute on a
            # DIFFERENT host (the member-failure path excludes every
            # host this request already tried)
            self._member_failed(
                p, m,
                NumericalError(
                    "fleet integrity certificate failed"
                ).with_context(routine=p.routine, tenant=p.tenant),
            )
            return
        self._deliver(p, m, X)

    # -- certification + quarantine -----------------------------------------

    def _certify(self, p: _FleetRequest, host: _Host,
                 X: np.ndarray) -> bool:
        """Router-side residual certificate, sampled per policy; a
        quarantined or rejoined host's delivery is certified
        REGARDLESS of the sampling rate (the probe must be the very
        next delivery, not the next sampled one)."""
        if p.routine not in ("gesv", "posv"):
            return True
        with self._lock:
            forced = host.probe_pending
        pol = self.policy
        if not forced:
            forced = host.score.suspect()
        if pol is None:
            if not forced:
                return True
            # defenses disarmed: a forced probe still certifies so a
            # rejoined host cannot silently serve garbage forever
        elif not forced and not pol.should_check():
            return True
        from ..integrity.policy import residual_certificate

        ok = residual_certificate(p.routine, p.A, X, p.B)
        metrics.inc("fleet.cert.checked")
        moved = host.score.observe(ok, time.monotonic())
        if moved == "quarantined":
            metrics.inc("fleet.quarantined")
            if spans.is_on():
                spans.event(
                    "host_quarantined", trace=p.trace, lane="router",
                    host=host.name,
                )
        elif moved == "recovered":
            metrics.inc("fleet.unquarantined")
        if ok:
            with self._lock:
                if host.probe_pending:
                    host.probe_pending = False
                    if host.state == HOST_REJOINED:
                        host.state = HOST_LIVE
                        metrics.inc("fleet.host_recovered")
        else:
            metrics.inc("fleet.cert.fail")
        return ok

    # -- delivery / failure (exactly-once) ----------------------------------

    def _deliver(self, p: _FleetRequest, m: _Member,
                 X: np.ndarray) -> None:
        with self._lock:
            if p.settled:
                won = False
            else:
                p.settled = True
                won = True
                self._pending.pop(p.rid, None)
            hedged = p.hedged
        if not won:
            if hedged:
                metrics.inc("fleet.hedge.wasted")
            return
        if hedged and m.hedge:
            metrics.inc("fleet.hedge.won")
        metrics.inc("fleet.delivered")
        now = time.monotonic()
        total_s = now - p.t_submit
        if metrics.is_on():
            metrics.observe_hist("fleet.latency.total", total_s)
            if self._tenant_tracked(p.tenant):
                metrics.observe_hist(
                    f"fleet.latency.tenant.{p.tenant}.total", total_s
                )
        adm = self._admission
        if adm is not None:
            # the router-measured burn feeds the global overload EWMA
            adm.observe_finish(
                None, p.tenant, p.prio, total_s, p.deadline_s, now,
                trace=p.trace, lane="router", windowed=False,
            )
        self._finish_spans(p, "ok")
        sync.hb_publish(p.future)
        p.future.set_result(X)

    def _member_typed(self, p: _FleetRequest, m: _Member,
                      reply: dict) -> None:
        """A worker answered with a typed error: deterministic, so it
        resolves the request (no cross-host retry) — EXCEPT a host-
        local Rejected, which re-dispatches: one full host must not
        refuse work the fleet has capacity for."""
        exc = _rebuild_exc(reply)
        if reply.get("error") == "Rejected":
            self._member_failed(p, m, exc)
            return
        self._resolve_exc(p, exc)

    def _member_failed(self, p: _FleetRequest, m: _Member,
                       exc: BaseException) -> None:
        """One member's dispatch failed (RPC error, cert failure, host
        Rejected).  Marks the member compensated, then re-dispatches or
        resolves through :meth:`_compensate` — exactly once per
        member, however many paths observe the same failure."""
        with self._lock:
            if p.settled or m.doomed:
                return
            m.doomed = True
        self._compensate(p, exc)

    def _compensate(self, p: _FleetRequest,
                    exc: BaseException) -> None:
        """Re-dispatch to an untried live host within budget; else let
        a surviving member finish; else resolve typed — a fleet future
        NEVER hangs."""
        with self._lock:
            if p.settled:
                return
            draining = self._draining
            budget_left = p.attempts <= self.redispatch_max
            other = (
                self._pick_host_locked(exclude=p.hosts_tried)
                if budget_left and not draining else None
            )
            survivors = other is None and p.alive_locked()
        if other is not None:
            metrics.inc("fleet.redispatched")
            if spans.is_on():
                spans.event(
                    "redispatch", trace=p.trace, lane="router",
                    to_host=other.name, cause=type(exc).__name__,
                )
            self._spawn_run(p, other, hedge=False)
            return
        if survivors:
            return  # the surviving member will deliver or fail
        if draining and not isinstance(exc, SlateError):
            exc = FleetError(
                "fleet draining: re-dispatch refused"
            ).with_context(routine=p.routine, tenant=p.tenant)
        elif isinstance(exc, (OSError, ConnectionError)):
            exc = HostDead(
                f"fleet host failed ({type(exc).__name__}) and no "
                "re-dispatch budget/host remains"
            ).with_context(routine=p.routine, tenant=p.tenant)
        self._resolve_exc(p, exc)

    def _resolve_exc(self, p: _FleetRequest, exc: BaseException) -> None:
        with self._lock:
            if p.settled:
                return
            p.settled = True
            self._pending.pop(p.rid, None)
        metrics.inc("fleet.typed_errors")
        self._finish_spans(p, type(exc).__name__)
        sync.hb_publish(p.future)
        p.future.set_exception(exc)

    def _finish_spans(self, p: _FleetRequest, outcome: str) -> None:
        spans.end(p.root, outcome=outcome)

    def _tenant_tracked(self, tenant: str) -> bool:
        if self._tenant_keys is None:
            self._tenant_keys = metrics.CappedKeys(64)
        return self._tenant_keys.track(tenant)

    # -- RPC ----------------------------------------------------------------

    def _rpc(self, host: _Host, header: dict, arrays=None,
             timeout: Optional[float] = None, retries: int = 0,
             solve: bool = False):
        """One bounded request/response round-trip.  Transient
        timeouts retry in place with decorrelated jitter
        (``fleet.rpc_retries``); connection errors propagate
        immediately (the dead-host fast path — retrying a refused
        connect just delays the fail-fast)."""
        timeout = self.rpc_timeout_s if timeout is None else timeout
        # seeded per (router, host): PYTHONHASHSEED-independent, so a
        # seeded drill's backoff sequence replays exactly
        rng = random.Random(
            (self.seed << 20) ^ sum(ord(c) for c in host.name)
        )
        prev = RPC_BACKOFF_BASE_S
        attempt = 0
        while True:
            try:
                if faults.is_on():
                    if faults.fire("host_partition") is not None:
                        # RPC blackhole: bytes vanish, no RST returns —
                        # indistinguishable from a timeout by design
                        raise socket.timeout("injected host_partition")
                    if solve and faults.fire("rpc_timeout") is not None:
                        raise socket.timeout("injected rpc_timeout")
                with socket.create_connection(
                    host.addr, timeout=timeout
                ) as s:
                    s.settimeout(timeout)
                    wire.send_msg(s, header, arrays)
                    return wire.recv_msg(s)
            except socket.timeout as e:
                attempt += 1
                if attempt > retries:
                    raise FleetTimeout(
                        f"fleet RPC to host {host.name} timed out "
                        f"after {attempt} attempts"
                    ) from e
                metrics.inc("fleet.rpc_retries")
                prev = decorrelated_backoff(rng, prev,
                                            RPC_BACKOFF_BASE_S)
                time.sleep(prev)

    # -- host lifecycle -----------------------------------------------------

    def _note_host_ok(self, host: _Host) -> None:
        with self._lock:
            host.fails = 0
            if host.state == HOST_SUSPECT:
                host.state = HOST_LIVE
                metrics.inc("fleet.host_recovered")
            elif host.state == HOST_DEAD:
                # answered again after death: rejoined — its next
                # delivery is the certification probe
                host.state = HOST_REJOINED
                host.probe_pending = True
                metrics.inc("fleet.host_rejoined")

    def _note_host_failure(self, host: _Host,
                           hard: bool = False) -> None:
        to_failfast: List[_FleetRequest] = []
        with self._lock:
            host.fails += 1
            if host.state in (HOST_LIVE, HOST_REJOINED):
                host.state = HOST_SUSPECT
                metrics.inc("fleet.host_suspect")
            if host.state == HOST_SUSPECT and (
                hard or host.fails >= self.dead_after
            ):
                host.state = HOST_DEAD
                host.died_at = time.monotonic()
                metrics.inc("fleet.host_dead")
                # typed fail-fast: every member inflight on this host
                # is doomed and compensated NOW (re-dispatch or typed
                # error), not at its RPC timeout; the stuck RPC
                # thread's own eventual failure finds doomed=True and
                # spends no further budget
                for p in self._pending.values():
                    if p.settled:
                        continue
                    doomed_any = False
                    for m in p.members:
                        if m.host is host and not m.finished \
                                and not m.doomed:
                            m.doomed = True
                            doomed_any = True
                    if doomed_any:
                        to_failfast.append(p)
        for p in to_failfast:
            self._compensate(
                p,
                HostDead(
                    f"fleet host {host.name} died with the request "
                    "inflight"
                ).with_context(routine=p.routine, tenant=p.tenant),
            )

    def _note_report(self, host: _Host, report: dict) -> None:
        """Fold one heartbeat report's stats in.  Stats ONLY: a report
        racing (or arriving after) a death transition must not
        resurrect the host — liveness flows through
        ``_note_host_ok``/``_note_host_failure`` alone."""
        with self._lock:
            host.queue_depth = int(report.get("queue_depth", 0))
            host.burn = report.get("burn")
            host.last_report = time.monotonic()
            burn = host.burn
        adm = self._admission
        if adm is not None and burn:
            # host-local burn EWMAs aggregate into the global
            # controller: overload anywhere sheds fleet-wide
            adm.observe_burn(float(burn), time.monotonic())

    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.wait(self.heartbeat_s):
            with self._lock:
                hosts = list(self._hosts.values())
            for h in hosts:
                try:
                    reply, _ = self._rpc(
                        h, {"op": "report"},
                        timeout=max(1.0, 2.0 * self.heartbeat_s),
                        retries=0,
                    )
                except (OSError, SlateError):
                    self._note_host_failure(h)
                    continue
                self._note_host_ok(h)
                self._note_report(h, reply)
            self._respawn_dead()
            self._hedge_sweep()

    def _respawn_dead(self) -> None:
        if not self.respawn:
            return
        with self._lock:
            dead = [
                h for h in self._hosts.values()
                if h.state == HOST_DEAD and h.proc is not None
                and h.proc.poll() is not None
                and time.monotonic() - h.died_at > self.heartbeat_s
            ]
        for h in dead:
            try:
                proc, addr = self._spawn_worker(
                    h.spawn_env or self._env_for(int(h.name))
                )
            except (OSError, ValueError, SlateError):
                continue  # next sweep retries
            with self._lock:
                h.proc = proc
                h.addr = addr
                # still DEAD until a heartbeat answers — rejoin (and
                # the probe) flow through _note_host_ok like any other
                # recovery
            metrics.inc("fleet.host_respawned")

    def _hedge_sweep(self) -> None:
        if self.hedge_s <= 0:
            return
        now = time.monotonic()
        targets: List[Tuple[_FleetRequest, _Host]] = []
        with self._lock:
            for p in self._pending.values():
                if p.settled or p.hedged or not p.alive_locked():
                    continue
                if now - p.t_submit < self.hedge_s:
                    continue
                other = self._pick_host_locked(exclude=p.hosts_tried)
                if other is None:
                    continue
                p.hedged = True
                targets.append((p, other))
        for p, other in targets:
            metrics.inc("fleet.hedge.sent")
            if spans.is_on():
                spans.event(
                    "hedge", trace=p.trace, lane="router",
                    to_host=other.name,
                )
            self._spawn_run(p, other, hedge=True)

    # -- observability ------------------------------------------------------

    def health(self) -> dict:
        """Fleet snapshot: per-host breaker state + stats + integrity
        score, pending count, and the global admission plane."""
        now = time.monotonic()
        with self._lock:
            hosts = {
                h.name: {
                    "state": h.state,
                    "addr": list(h.addr),
                    "inflight": h.inflight,
                    "queue_depth": h.queue_depth,
                    "fails": h.fails,
                    "probe_pending": h.probe_pending,
                    "burn": h.burn,
                    "score": h.score.snapshot(now),
                }
                for h in self._hosts.values()
            }
            pending = len(self._pending)
            draining = self._draining
        adm = self._admission
        return {
            "hosts": hosts,
            "pending": pending,
            "draining": draining,
            "admission": adm.snapshot() if adm is not None else None,
            "tenants": (
                adm.tenants_health({}, now=now)
                if adm is not None else None
            ),
        }

    def dump_hosts(self, directory: str,
                   timeout: float = 15.0) -> List[dict]:
        """Ask every non-dead host to dump its metrics JSONL + span
        ring into ``directory`` (``host<i>.metrics.jsonl`` /
        ``host<i>.trace.json``) — the fan-in half of stitched
        observability.  Returns the per-host dump replies."""
        with self._lock:
            hosts = [
                h for h in self._hosts.values() if h.state != HOST_DEAD
            ]
        out = []
        for h in hosts:
            try:
                reply, _ = self._rpc(
                    h,
                    {
                        "op": "dump",
                        "label": f"host{h.name}",
                        "metrics": os.path.join(
                            directory, f"host{h.name}.metrics.jsonl"
                        ),
                        "trace": os.path.join(
                            directory, f"host{h.name}.trace.json"
                        ),
                    },
                    timeout=timeout, retries=0,
                )
            except (OSError, SlateError):
                continue
            reply["host"] = h.name
            out.append(reply)
        return out


def _drain_pipe(pipe) -> None:
    try:
        for _ in pipe:
            pass
    except (OSError, ValueError):
        pass


def _rebuild_exc(reply: dict) -> SlateError:
    """Re-raise a worker's typed error as the same class (by name,
    from the serve taxonomy) with its structured context attached."""
    from ..serve import service as _svc
    from .. import exceptions as _exc

    name = reply.get("error") or "SlateError"
    cls = getattr(_svc, name, None)
    if not (isinstance(cls, type) and issubclass(cls, SlateError)):
        cls = getattr(_exc, name, None)
    if not (isinstance(cls, type) and issubclass(cls, SlateError)):
        cls = FleetError
    e = cls(reply.get("message") or name)
    ctx = reply.get("context") or {}
    return e.with_context(**{
        k: ctx[k]
        for k in ("routine", "bucket", "attempt", "tenant", "priority")
        if ctx.get(k) is not None
    })
