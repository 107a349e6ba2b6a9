"""SolverService: bounded admission, same-bucket batch coalescing, a
factor cache, deadlines, retries with backoff and circuit-breaker
recovery — the JAX package's ``serve/service.py`` in its default form:
one replica lane on one device, with the admission, integrity,
sharding, artifact and autoscaling planes off.

Execution model:

* ``submit()`` validates (non-finite A/B -> immediate
  :class:`~slate_tpu_torch.exceptions.InvalidInput` before any queue or
  build cost; ``validate=False`` opts out), buckets the request
  (``buckets.bucket_for``) and enqueues it on the lane.  A full queue
  (``max_queue``) rejects immediately with :class:`Rejected`.
* The lane's worker thread runs inside ``torch.cuda.device(lane
  device)``, so every launch lands on the lane's device and on that
  thread's current stream.  It pops the oldest eligible request (one
  whose retry backoff has elapsed), waits up to ``batch_window_s`` for
  company, then coalesces every queued request with the same BucketKey
  (and factor fingerprint) up to ``batch_max`` into one batch padded to
  the fixed batch point (``buckets.batch_bucket``), so only two
  executables exist per bucket and a warmed steady state never makes a
  cold build.
* Supervision: the worker runs under a guard that catches any death
  (including the ``worker_death`` fault site), re-enqueues its
  in-flight requests that still have retry budget, fails the rest fast
  with a typed error, respawns itself and counts
  ``serve.worker_restarts`` — no future ever hangs.
* Deadlines: a request whose deadline passes while queued is cancelled
  with :class:`DeadlineExceeded` (``serve.deadline_miss_queued``); one
  that finishes late is delivered and counted
  (``serve.deadline_miss_late``); ``serve.deadline_miss`` is the sum.
* Failures: an executable exception re-enqueues the batch's requests
  while they have ``retries`` left, each delayed by decorrelated-jitter
  backoff (:func:`decorrelated_backoff`, seeded); past the budget each
  falls back to the direct driver on the same device
  (``serve.fallbacks``).  A kernel that fails to build or launch takes
  this chain too; nothing moves to the CPU.
* Circuit breaker (``buckets.Breaker``, per BucketKey): ``degrade_after``
  consecutive batched failures open it (requests go direct), after
  ``breaker_cooldown_s`` it half-opens and the next batch probes; one
  healthy probe closes it.
* A nonzero per-item ``info`` raises
  :class:`~slate_tpu_torch.exceptions.NumericalError` on that item only;
  a non-finite solution for finite inputs (``result_corrupt``) is
  re-solved direct, counted ``serve.corrupt_result``.
* Factor cache (``serve/factor_cache.py``, off by default): eligible
  requests are fingerprinted at admission; a hit dispatches the
  trsm-only ``phase="solve"`` bucket against the cached factor on the
  device (only B is uploaded), a miss factors once through the drivers
  and caches the factor.  Every hit is residual-checked on the host: a
  factor that no longer matches A (``factor_stale``) is dropped and the
  request re-solved, never a wrong X.

Results are numpy arrays: the copy to the host is a dispatch's
synchronisation point, and ``info`` is read once an item.  Every
exception set on a future carries ``routine``/``bucket``/``attempt``
context (:meth:`SlateError.with_context`).

Metrics (JAX package names): ``serve.queue_depth``,
``serve.replica.0.{queue_depth,dispatched,oldest_queued_s}``,
``serve.requests``, ``serve.replicated_dispatch``, ``serve.batched``,
``serve.batched_requests``, ``serve.batch_pad``,
``serve.bucket_pad_waste``, ``serve.deadline_miss`` (+ ``_queued`` /
``_late``), ``serve.rejected``, ``serve.invalid_input``,
``serve.retries`` + the ``serve.retry_backoff_s`` timer,
``serve.fallbacks``, ``serve.direct_only``, ``serve.worker_restarts``,
``serve.breaker_open`` / ``half_open`` / ``closed`` (and
``serve.degraded``), ``serve.numerical_errors``,
``serve.corrupt_result``, ``serve.factor_cache.*``, the
``serve.latency.<bucket>.{queued,execute,total}`` and
``serve.latency.replica.0.total`` histograms, and the
``serve.slo_burn.*`` tiers.  With ``aux/spans`` on, every request
carries a trace id and a ``request`` -> ``admit``/``queued``/
``coalesce``/``execute`` | ``direct``/``factor``/``backoff`` chain.

Not ported yet (ROADMAP.md Queue 1 items 4b and 7): replicas
(``add_replica``/``remove_replica``), restore and artifacts, tenant
floods, certification, hedging and the sharded lane.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import random
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Union

import numpy as np
import torch

from ..aux import faults, metrics, spans, sync
from ..exceptions import InvalidInput, NumericalError, SlateError
from ..integrity import policy as _integ
from . import admission as _adm
from . import buckets as _bk
from .cache import ExecutableCache, direct_call
from .factor_cache import (
    FactorCache,
    FactorEntry,
    cache_from_options,
    factor_only,
    gels_factor_pack,
    matrix_fingerprint,
    pad_square_t,
    residual_ok,
    solve_from_factor,
)
from .factor_cache import record as _fc_record
from .placement import PlacementPolicy


class Rejected(SlateError):
    """Queue-full backpressure: the request was never admitted."""


class DeadlineExceeded(SlateError):
    """The request's deadline passed before execution started."""


class Shed(SlateError):
    """Load shed under sustained overload (the admission plane's refusal;
    raised only once that plane is ported, ROADMAP.md Queue 1 item 7)."""


#: ceiling for one decorrelated-jitter backoff step, seconds
BACKOFF_CAP_S = 2.0

#: readiness phases (health()["phase"]); without an artifact store a
#: started service is ready at once
PHASE_COLD = "cold"
PHASE_RESTORING = "restoring"
PHASE_READY = "ready"

LANE_LIVE = "live"


def decorrelated_backoff(rng: random.Random, prev_s: float, base_s: float,
                         cap_s: float = BACKOFF_CAP_S) -> float:
    """One step of exponential backoff with decorrelated jitter:
    ``sleep_{k+1} = min(cap, U(base, 3 sleep_k))``, ``sleep_0 = base``.
    Pure in ``rng``, so a seeded RNG replays the exact delays."""
    hi = max(base_s, 3.0 * prev_s)
    return min(cap_s, rng.uniform(base_s, hi))


@dataclass(eq=False)
class _Request:
    # eq=False: requests are identities (the queues remove() by identity)
    routine: str
    key: Optional[_bk.BucketKey]  # None => direct-only (gels m < n)
    A: np.ndarray
    B: np.ndarray
    m: int
    n: int
    nrhs: int
    future: Future = field(default_factory=Future)
    deadline: Optional[float] = None  # absolute time.monotonic()
    retries: int = 0
    attempt: int = 0  # batched attempts so far (error context)
    backoff_s: float = 0.0  # last backoff delay (jitter state)
    not_before: float = 0.0  # monotonic eligibility time after a retry
    t_submit: float = field(default_factory=time.monotonic)
    # factor cache: fingerprint of A, and whether admission missed (the
    # request factors through _factor_direct instead of the batched path)
    factor_fp: Optional[str] = None
    factor_miss: bool = False
    # tracing (all None when spans are off): trace id, root span, the
    # live "queued" span
    trace: Optional[str] = None
    span: Optional[spans.Span] = None
    qspan: Optional[spans.Span] = None

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic()) > self.deadline)


class _Replica:
    """One serving lane: a queue, a supervised worker, per-bucket
    breakers and the device its dispatches run on.  Its mutable state
    is owned by the service's condition lock."""

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.device = device
        self.q: Deque[_Request] = deque()  # guarded by: _cond
        self.inflight: List[_Request] = []  # guarded by: _cond
        self.breakers: Dict[_bk.BucketKey, _bk.Breaker] = {}  # guarded by: _cond
        self.thread: Optional[threading.Thread] = None
        self.restarts = 0
        self.dispatched = 0
        self.q_gauge = f"serve.replica.{name}.queue_depth"
        self.dispatched_counter = f"serve.replica.{name}.dispatched"
        self.oldest_gauge = f"serve.replica.{name}.oldest_queued_s"
        self.lat_hist = f"serve.latency.replica.{name}.total"
        self.lane = f"replica-{name}"

    def alive(self) -> bool:
        return bool(self.thread is not None and self.thread.is_alive())


class SolverService:
    """Batching solver service over the driver stack, one lane.

    Parameters (the JAX package's; None reads the Serve* Option default)
    ----------
    cache: :class:`ExecutableCache` (built from ``SLATE_TPU_WARMUP`` when
        omitted).
    max_queue: admission limit; ``submit`` past it raises Rejected.
    batch_max: coalesced batch point.
    batch_window_s: how long the worker lingers for company.
    dim_floor / nrhs_floor: bucket lattice floors.
    degrade_after: consecutive batched failures before the breaker opens.
    breaker_cooldown_s: open -> half-open delay.
    retry_backoff_s / retry_backoff_cap_s / retry_seed: the backoff.
    validate: admission-time finiteness checks.
    schedule: factorization schedule of the bucket cores (part of the
        BucketKey).
    precision: "full" | "mixed" solve path of the bucket cores.
    placement: :class:`PlacementPolicy` — one lane on ``cuda:0`` unless
        its ``devices`` name another (the tests pass the CPU).
    replicas: must be 1 (replica scale-out is not ported yet).
    factor_cache: :class:`FactorCache`, or None to resolve
        ``SLATE_TPU_FACTOR_CACHE`` / ``Option.ServeFactorCache*`` (off
        by default), or False to disable it over the env.
    tenants / adaptive: the admission plane; set, it raises (not ported
        yet).  integrity: likewise.
    faults_spec: aux/faults grammar; arms and enables injection, which
        the service owns and disarms on :meth:`stop`.
    start: False builds paused (tests; call :meth:`start`).
    """

    def __init__(
        self,
        cache: Optional[ExecutableCache] = None,
        max_queue: Optional[int] = None,
        batch_max: Optional[int] = None,
        batch_window_s: Optional[float] = None,
        dim_floor: int = _bk.DIM_FLOOR,
        nrhs_floor: int = _bk.NRHS_FLOOR,
        degrade_after: int = 2,
        breaker_cooldown_s: Optional[float] = None,
        retry_backoff_s: Optional[float] = None,
        retry_backoff_cap_s: float = BACKOFF_CAP_S,
        retry_seed: int = 0,
        validate: Optional[bool] = None,
        schedule: Optional[str] = None,
        precision: Optional[str] = None,
        placement: Optional[PlacementPolicy] = None,
        replicas: Optional[int] = None,
        factor_cache: Union[FactorCache, bool, None] = None,
        tenants=None,
        adaptive: Optional[bool] = None,
        integrity=None,
        faults_spec: Optional[str] = None,
        start: bool = True,
    ):
        from ..enums import Option, Schedule
        from ..options import get_option

        def opt(value, key):
            return value if value is not None else get_option(None, key)

        self.placement = (placement if placement is not None
                          else PlacementPolicy.from_options(replicas=replicas))
        lane_device = self.placement.device_for(0)  # raises without a device
        self.cache = cache if cache is not None else ExecutableCache()
        self.max_queue = int(opt(max_queue, Option.ServeQueueLimit))
        self.batch_max = int(opt(batch_max, Option.ServeBatchMax))
        self.batch_window_s = float(opt(batch_window_s, Option.ServeBatchWindow))
        self.dim_floor = int(dim_floor)
        self.nrhs_floor = int(nrhs_floor)
        self.degrade_after = int(degrade_after)
        self.breaker_cooldown_s = float(opt(breaker_cooldown_s, Option.ServeBreakerCooldown))
        self.retry_backoff_s = float(opt(retry_backoff_s, Option.ServeRetryBackoff))
        self.retry_backoff_cap_s = float(retry_backoff_cap_s)
        self.validate = bool(opt(validate, Option.ServeValidate))
        if schedule is None:
            schedule = get_option(None, Option.Schedule, Schedule.Auto)
        self.schedule = (schedule.value if isinstance(schedule, Schedule)
                         else Schedule.from_string(str(schedule)).value)
        self.precision = _bk.check_precision(
            precision if precision is not None
            else get_option(None, Option.ServePrecision) or "full")
        self.factor_cache = (None if factor_cache is False
                             else factor_cache if factor_cache is not None
                             else cache_from_options())
        # the planes that are not ported raise when configured, else None
        _adm.AdmissionControl.from_options(tenants=tenants, adaptive=adaptive)
        _integ.from_options(integrity)
        if faults_spec is None:
            faults_spec = get_option(None, Option.Faults) or ""
        # injection is process-global; the arming service disarms on stop()
        self._owns_faults = bool(faults_spec)
        if faults_spec:
            faults.configure(faults_spec)
            faults.on()
        self._phase = PHASE_COLD
        self._rng = random.Random(retry_seed)
        self._cond = sync.Condition(name="service.SolverService._cond")
        self._running = False
        self._stopped = False  # stop() called; submit() rejects until start()
        self._replicas: List[_Replica] = [_Replica("0", lane_device)]
        self._restarts = 0
        self._recent_fail: Deque[float] = deque(maxlen=256)
        self._seen_labels: set = set()  # labels health() reports latency for
        self._t_started = time.monotonic()
        if start:
            self.start()

    # -- lanes -------------------------------------------------------------

    @property
    def _breakers(self) -> Dict[_bk.BucketKey, _bk.Breaker]:
        """The lane's live breaker table (tests poke Breaker fields)."""
        return self._replicas[0].breakers

    def _gauge_queues_locked(self) -> int:
        total = 0
        mon = metrics.is_on()
        now = time.monotonic() if mon else 0.0
        for rep in self._replicas:
            d = len(rep.q)
            total += d
            metrics.gauge(rep.q_gauge, d)
            if mon:
                metrics.gauge(rep.oldest_gauge,
                              (now - min(r.t_submit for r in rep.q)) if rep.q else 0.0)
        metrics.gauge("serve.queue_depth", total)
        return total

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "SolverService":
        with self._cond:
            if self._running:
                return self
            self._running = True
            self._stopped = False
            self._phase = PHASE_READY  # nothing to restore without a store
            self._cond.notify_all()
        for rep in self._replicas:
            self._spawn_worker(rep)
        return self

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """True once the service is ready.  Without an artifact store
        there is no restore pass to wait for: a started service is ready
        at once, and one built paused and never started returns False at
        once (``timeout`` is accepted for the JAX package's signature)."""
        with self._cond:
            return self._phase == PHASE_READY

    def warmup(self, path: Optional[str] = None, verbose: bool = False) -> int:
        """Cold-build the manifest's executables on the lane's device;
        returns the number built."""
        return self.cache.warmup(path=path, batch_max=self.batch_max,
                                 devices=self.placement.replica_devices(), verbose=verbose)

    def _spawn_worker(self, rep: _Replica) -> None:
        t = threading.Thread(target=self._run_worker, args=(rep,),
                             name=f"slate-serve-worker-{rep.name}", daemon=True)
        with self._cond:
            rep.thread = t
        t.start()

    def stop(self, timeout: float = 10.0, drain: bool = False,
             drain_timeout: Optional[float] = None) -> None:
        """Stop the worker; queued and leftover requests resolve with
        Rejected (futures never hang).

        ``drain=True``: admission closes at once (new submits raise
        Rejected) but the worker runs on until every admitted request has
        resolved, bounded by ``drain_timeout`` (``Option.ServeDrainTimeout``
        when None); completed ones count ``serve.drained``, those still
        pending at the bound ``serve.drain_abandoned``."""
        if drain:
            if drain_timeout is None:
                from ..enums import Option
                from ..options import get_option

                drain_timeout = float(get_option(None, Option.ServeDrainTimeout))
            deadline_d = time.monotonic() + max(float(drain_timeout), 0.0)

            def pending_locked() -> int:
                return sum(len(rep.q) + len(rep.inflight) for rep in self._replicas)

            with self._cond:
                self._stopped = True  # close admission; the worker keeps going
                start_pending = left = pending_locked()
                while left and time.monotonic() < deadline_d:
                    self._cond.wait(0.02)
                    left = pending_locked()
            metrics.inc("serve.drained", max(start_pending - left, 0))
            if left:
                metrics.inc("serve.drain_abandoned", left)
        with self._cond:
            self._running = False
            self._stopped = True
            leftovers: List[_Request] = []
            for rep in self._replicas:
                leftovers.extend(rep.q)
                rep.q.clear()
            self._gauge_queues_locked()
            self._cond.notify_all()
            threads = [rep.thread for rep in self._replicas]
        deadline = time.monotonic() + timeout
        for t in threads:
            if t is not None:
                t.join(max(0.0, deadline - time.monotonic()))
        with self._cond:
            for rep, t in zip(self._replicas, threads):
                if rep.thread is t:
                    rep.thread = None
        for r in leftovers:
            _resolve_exc(r.future, Rejected("service stopped"), req=r)
        if self._owns_faults:
            faults.reset()
            self._owns_faults = False

    def __enter__(self) -> "SolverService":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- admission ---------------------------------------------------------

    def submit(self, routine: str, A, B, deadline: Optional[float] = None,
               retries: int = 0, precision: Optional[str] = None,
               sharded: Optional[bool] = None, tenant: Optional[str] = None,
               priority=None, trace_id: Optional[str] = None) -> Future:
        """Enqueue one solve; returns a Future resolving to the cropped
        solution X (an (n, nrhs) numpy array).

        ``deadline`` is seconds from now; ``retries`` re-runs the batched
        path (with backoff) on executable failure before falling back.
        ``precision`` ("full"|"mixed") overrides the service's solve path
        for gesv/posv.  ``sharded=True`` raises (no mesh); ``tenant`` /
        ``priority`` are validated (the admission plane that acts on them is
        not ported).  Raises :class:`Rejected` on a full
        queue and :class:`InvalidInput` on non-finite operands."""
        if not spans.is_on():
            return self._submit(routine, A, B, deadline, retries, precision, sharded,
                                tenant, priority)
        tr = trace_id or spans.new_trace()
        root = spans.start("request", trace=tr, lane="client", routine=routine)
        admit = spans.start("admit", trace=tr, parent=root, lane="client")
        try:
            fut = self._submit(routine, A, B, deadline, retries, precision, sharded,
                               tenant, priority, _trace=tr, _root=root)
        except BaseException as e:
            spans.end(admit, outcome=type(e).__name__)
            spans.end(root, outcome=type(e).__name__)
            raise
        spans.end(admit, outcome="enqueued")
        return fut

    def _submit(self, routine: str, A, B, deadline: Optional[float] = None,
                retries: int = 0, precision: Optional[str] = None,
                sharded: Optional[bool] = None, tenant: Optional[str] = None,
                priority=None, _trace: Optional[str] = None,
                _root: Optional[spans.Span] = None) -> Future:
        _adm.resolve_identity(tenant, priority)  # a bad tag fails as with the plane on
        A = np.asarray(A)
        B = np.asarray(B)
        if B.ndim == 1:
            B = B[:, None]
        if A.ndim != 2 or B.ndim != 2 or A.shape[0] != B.shape[0]:
            raise ValueError(f"{routine}: bad shapes A{A.shape} B{B.shape}")
        if self.validate:
            bad = ("A" if not np.all(np.isfinite(A))
                   else "B" if not np.all(np.isfinite(B)) else None)
            if bad is not None:
                metrics.inc("serve.invalid_input")
                raise InvalidInput(f"{routine}: non-finite entries in {bad}"
                                   ).with_context(routine=routine)
        m, n = A.shape
        nrhs = B.shape[1]
        prec = _bk.check_precision(precision if precision is not None else self.precision)
        if sharded:
            raise ValueError(f"{routine}: sharded routing unavailable (no mesh "
                             "configured, or the routine has no sharded path)")
        key: Optional[_bk.BucketKey] = None
        if not (routine == "gels" and m < n):
            key = _bk.bucket_for(routine, m, n, nrhs, A.dtype, floor=self.dim_floor,
                                 nrhs_floor=self.nrhs_floor, schedule=self.schedule,
                                 precision=prec)
        # factor cache (one branch when disabled): classify hit / miss
        fc = self.factor_cache
        fp: Optional[str] = None
        hit: Optional[FactorEntry] = None
        full_key = key
        if (fc is not None and key is not None and prec == "full"
                and routine in ("gesv", "posv", "gels")):
            fp = matrix_fingerprint(A, routine, schedule=self.schedule, precision=prec)
            hit = fc.get(fp)
            if hit is not None:
                # the request's own solve bucket: a same-A request with
                # another nrhs bucket dispatches at its own shape
                key = full_key.solve_sibling()
            else:
                _fc_record("miss", fp=fp, label=key.label)
        req = _Request(
            routine=routine, key=key, A=A, B=B, m=m, n=n, nrhs=nrhs,
            deadline=time.monotonic() + deadline if deadline is not None else None,
            retries=int(retries), factor_fp=fp,
            factor_miss=bool(fp is not None and hit is None), trace=_trace, span=_root,
        )
        if _root is not None:
            spans.annotate(_root, bucket=key.label if key is not None else None,
                           sharded=False)
        with self._cond:
            if self._stopped:
                metrics.inc("serve.rejected")
                raise Rejected("service stopped; configure() a new one"
                               ).with_context(routine=routine)
            if sum(len(rep.q) for rep in self._replicas) >= self.max_queue:
                metrics.inc("serve.rejected")
                raise Rejected(f"queue full ({self.max_queue}); retry with backoff"
                               ).with_context(routine=routine)
            rep = self._replicas[0]
            if hit is not None:
                own = next((r for r in self._replicas if r.name == hit.replica), None)
                b = own.breakers.get(key) if own is not None else None
                if b is not None and b.cooling_down(time.monotonic(),
                                                    self.breaker_cooldown_s):
                    # the owning lane's solve bucket is cooling down: spill
                    # off the batched solve executable onto the direct
                    # factor path, which reuses the healthy factor
                    # (residual-fenced) or refactors — never a dispatch
                    # into a known-sick path
                    _fc_record("spill", fp=fp, label=full_key.label)
                    req.key = key = full_key
                    req.factor_miss = True
            if _root is not None:
                req.qspan = spans.start("queued", trace=_trace, parent=_root,
                                        lane=rep.lane)
            rep.q.append(req)
            self._gauge_queues_locked()
            self._cond.notify_all()
        if key is not None:
            metrics.inc("serve.replicated_dispatch")
        metrics.inc("serve.requests")
        return req.future

    def queue_depth(self) -> int:
        with self._cond:
            return sum(len(rep.q) for rep in self._replicas)

    # -- health ------------------------------------------------------------

    def health(self) -> dict:
        """Liveness/readiness snapshot: queue depth vs limit, worker
        liveness, restarts, dispatch counts, breaker states, the age of
        the oldest queued request, the recent failure rate (last 60 s)
        and, with metrics on, per-bucket p50/p95/p99 total latency
        (``latency``) and the deadline-budget burn tiers (``slo_burn``)."""
        now = time.monotonic()
        window_s = 60.0
        with self._cond:
            depth = sum(len(rep.q) for rep in self._replicas)
            alive = all(rep.alive() for rep in self._replicas)
            running = self._running
            restarts = self._restarts
            inflight = sum(len(rep.inflight) for rep in self._replicas)
            merged: Dict[str, str] = {}
            lanes = []
            for rep in self._replicas:
                states = {k.label: b.state for k, b in rep.breakers.items()}
                merged.update(states)
                lanes.append({
                    "name": rep.name, "state": LANE_LIVE, "device": str(rep.device),
                    "queue_depth": len(rep.q), "inflight": len(rep.inflight),
                    "oldest_queued_s": (now - min(r.t_submit for r in rep.q)) if rep.q
                    else 0.0,
                    "worker_alive": rep.alive(), "restarts": rep.restarts,
                    "dispatched": rep.dispatched, "breakers": states,
                })
            recent = [t for t in self._recent_fail if now - t <= window_s]
            phase = self._phase
            seen_labels = sorted(self._seen_labels)
        latency: Dict[str, dict] = {}
        slo_burn: Dict[str, int] = {}
        if metrics.is_on():
            for lbl in seen_labels:
                s = metrics.hist_summary(f"serve.latency.{lbl}.total")
                if s:
                    latency[lbl] = {k: s[k] for k in ("count", "p50", "p95", "p99")}
            slo_burn = {name.rsplit(".", 1)[1]: int(v)
                        for name, v in metrics.counters().items()
                        if name.startswith("serve.slo_burn.")}
        return {
            "ok": running and alive,
            "phase": phase,
            "ready": bool(running and alive and phase == PHASE_READY),
            "running": running,
            "worker_alive": alive,
            "worker_restarts": restarts,
            "queue_depth": depth,
            "queue_limit": self.max_queue,
            "inflight": inflight,
            "breakers": merged,
            "open_buckets": sorted(l for l, s in merged.items() if s == _bk.BREAKER_OPEN),
            "replicas": lanes,
            "latency": latency,
            "slo_burn": slo_burn,
            "factor_cache": (self.factor_cache.stats()
                             if self.factor_cache is not None else None),
            "failures_60s": len(recent),
            "failure_rate_60s": len(recent) / window_s,
            "uptime_s": now - self._t_started,
        }

    def _note_failure(self) -> None:
        with self._cond:
            self._recent_fail.append(time.monotonic())

    # -- supervision -------------------------------------------------------

    def _run_worker(self, rep: _Replica) -> None:
        ctx = (torch.cuda.device(rep.device) if rep.device.type == "cuda"
               else contextlib.nullcontext())
        try:
            with ctx:
                self._loop(rep)
        except BaseException as e:  # noqa: BLE001 — supervise any death
            self._supervise(rep, e)

    def _supervise(self, rep: _Replica, exc: BaseException) -> None:
        """Worker-death containment: re-enqueue the lane's in-flight
        requests that still have retry budget (with backoff), fail the
        rest fast with a typed error, and respawn the worker."""
        metrics.inc("serve.worker_restarts")
        with self._cond:
            inflight, rep.inflight = rep.inflight, []
            rep.restarts += 1
            self._restarts += 1
            running = self._running
        self._note_failure()
        for r in inflight:
            if r.future.done():
                continue
            if running and r.retries > 0:
                self._requeue_with_backoff(rep, r)
            else:
                _resolve_exc(r.future, SlateError(f"worker died mid-batch: {exc!r}"),
                             req=r)
        if running:
            self._spawn_worker(rep)

    # -- worker ------------------------------------------------------------

    def _loop(self, rep: _Replica) -> None:
        while True:
            batch = self._next_batch(rep)
            if batch is None:
                return
            if not batch:
                continue
            with self._cond:
                rep.inflight = batch
            faults.check("worker_death")  # in flight: supervision must cover
            self._execute(rep, batch)
            with self._cond:
                rep.inflight = []

    @staticmethod
    def _pop_eligible_locked(rep: _Replica, now: float) -> Optional[_Request]:
        """Oldest request whose retry backoff has elapsed."""
        for i, r in enumerate(rep.q):
            if r.not_before <= now:
                del rep.q[i]
                return r
        return None

    def _next_batch(self, rep: _Replica) -> Optional[List[_Request]]:
        """Pop the oldest eligible request plus every same-key,
        same-fingerprint eligible request (up to batch_max).  None =>
        stopped; [] => only expired requests were popped this round."""
        expired: List[_Request] = []
        with self._cond:
            first: Optional[_Request] = None
            while self._running:
                now = time.monotonic()
                # deadline sweep of the whole queue before eligibility: a
                # request backing off is still cancelled when its deadline
                # passes, not after its backoff elapses
                if rep.q:
                    dead = [r for r in rep.q if r.expired()]
                    for r in dead:
                        rep.q.remove(r)
                    expired.extend(dead)
                if expired:
                    break  # cancel outside the lock, then come back
                first = self._pop_eligible_locked(rep, now)
                if first is not None:
                    break
                if rep.q:  # everything is backing off: sleep to the next
                    wake = min(r.not_before for r in rep.q) - now
                    self._cond.wait(min(max(wake, 0.001), 0.05))
                else:
                    self._cond.wait(0.05)
            if not self._running:
                # anything the failure path re-enqueued after stop()
                # drained the queue resolves here: futures never strand
                leftovers = list(rep.q)
                rep.q.clear()
                for r in leftovers:
                    _resolve_exc(r.future, Rejected("service stopped"), req=r)
                return None
            self._gauge_queues_locked()
        if expired:
            for r in expired:
                self._miss_queued(r)
            return []
        if first.expired():
            self._miss_queued(first)
            return []
        if first.key is None:
            return [first]  # keyless requests run direct
        csp = (spans.start("coalesce", trace=first.trace, parent=first.span, lane=rep.lane)
               if first.trace is not None else None)

        def company(r: _Request, now: float) -> bool:
            return (r.key == first.key and r.factor_fp == first.factor_fp
                    and r.not_before <= now)

        if self.batch_max > 1 and self.batch_window_s > 0:
            with self._cond:
                now = time.monotonic()
                if not any(company(r, now) for r in rep.q):
                    self._cond.wait(self.batch_window_s)
        batch = [first]
        with self._cond:
            now = time.monotonic()
            take = [r for r in rep.q if company(r, now)][: self.batch_max - 1]
            for r in take:
                rep.q.remove(r)
            batch.extend(take)
            self._gauge_queues_locked()
        spans.end(csp, coalesced=len(batch))
        live = []
        for r in batch:
            if r.expired():
                self._miss_queued(r)
            else:
                live.append(r)
        return live

    def _miss_queued(self, req: _Request) -> None:
        """Deadline passed while still queued: cancel, never start."""
        if req.future.done():
            return
        metrics.inc("serve.deadline_miss")
        metrics.inc("serve.deadline_miss_queued")
        _resolve_exc(req.future, DeadlineExceeded(
            f"{req.routine} {req.m}x{req.n}: deadline passed after "
            f"{time.monotonic() - req.t_submit:.3f}s in queue"), req=req)

    @staticmethod
    def _miss_late(req: Optional[_Request] = None) -> None:
        """Finished past the deadline: result still delivered, counted."""
        metrics.inc("serve.deadline_miss")
        metrics.inc("serve.deadline_miss_late")

    # -- execution ---------------------------------------------------------

    def _breaker(self, rep: _Replica, key: _bk.BucketKey) -> _bk.Breaker:
        with self._cond:  # health() iterates breaker tables under the lock
            br = rep.breakers.get(key)
            if br is None:
                br = rep.breakers[key] = _bk.Breaker()
        return br

    def _breaker_opened(self, rep: _Replica, key: _bk.BucketKey, trace, **attrs) -> None:
        metrics.inc("serve.breaker_open")
        metrics.inc(f"serve.replica.{rep.name}.breaker_open")
        metrics.inc("serve.degraded")  # the JAX package's alias of open events
        spans.event("breaker_open", trace=trace, lane=rep.lane, bucket=key.label, **attrs)

    def _execute(self, rep: _Replica, batch: List[_Request]) -> None:
        rep.dispatched += len(batch)
        metrics.inc(rep.dispatched_counter, len(batch))
        key = batch[0].key
        if metrics.is_on():
            # queued half of the latency split: admit -> first dispatch
            now = time.monotonic()
            lbl = self._lat_label(batch[0])
            for r in batch:
                if r.attempt == 0:
                    metrics.observe_hist(f"serve.latency.{lbl}.queued", now - r.t_submit)
        if spans.is_on():
            for r in batch:
                spans.end(r.qspan, outcome="dispatched", replica=rep.name)
        if key is None:
            for r in batch:
                self._direct(r)
            return
        if batch[0].factor_miss:
            # factor-cache miss: factor once through the drivers, solve,
            # cache, and register the solve bucket for the hits to come
            for r in batch:
                self._factor_direct(rep, r)
            return
        br = self._breaker(rep, key)
        if br.state == _bk.BREAKER_OPEN:
            if br.try_half_open(time.monotonic(), self.breaker_cooldown_s):
                metrics.inc("serve.breaker_half_open")
                spans.event("breaker_half_open", trace=batch[0].trace, lane=rep.lane,
                            bucket=key.label)
            else:
                for r in batch:  # open: route direct until the cooldown
                    self._direct(r)
                return
        try:
            for r in batch:
                r.attempt += 1
            deliver, corrupt = self._execute_batched(rep, key, batch)
        except Exception as e:  # noqa: BLE001 — futures carry the error
            self._note_failure()
            if br.record_failure(time.monotonic(), self.degrade_after):
                self._breaker_opened(rep, key, batch[0].trace)
            retryable = [r for r in batch if r.retries > 0]
            rest = [r for r in batch if r.retries <= 0]
            for r in reversed(retryable):
                self._requeue_with_backoff(rep, r)
            for r in rest:
                self._direct(r, batched_error=e)
            return
        if corrupt:
            # delivered garbage is a batched-path failure even though
            # nothing raised
            if br.record_failure(time.monotonic(), self.degrade_after):
                self._breaker_opened(rep, key, batch[0].trace, corrupt=True)
        elif corrupt is None:
            pass  # the batched path never ran: a half-open probe stays pending
        elif br.record_success():
            metrics.inc("serve.breaker_closed")  # half-open probe healed
            metrics.inc(f"serve.replica.{rep.name}.breaker_closed")
            spans.event("breaker_closed", trace=batch[0].trace, lane=rep.lane,
                        bucket=key.label)
        # resolve only after the breaker transition committed
        for fn in deliver:
            fn()

    def _requeue_with_backoff(self, rep: _Replica, r: _Request) -> None:
        """Retry after exponential backoff with decorrelated jitter."""
        r.retries -= 1
        r.backoff_s = decorrelated_backoff(self._rng, r.backoff_s, self.retry_backoff_s,
                                           self.retry_backoff_cap_s)
        r.not_before = time.monotonic() + r.backoff_s
        metrics.inc("serve.retries")
        metrics.observe("serve.retry_backoff_s", r.backoff_s)
        if r.trace is not None and spans.is_on():
            t = spans.now()
            spans.record("backoff", t, t + r.backoff_s, trace=r.trace, parent=r.span,
                         lane=rep.lane, backoff_s=round(r.backoff_s, 6),
                         retries_left=r.retries, attempt=r.attempt)
        with self._cond:
            if r.span is not None and spans.is_on():
                r.qspan = spans.start("queued", trace=r.trace, parent=r.span,
                                      lane=rep.lane, retry=True)
            rep.q.appendleft(r)
            self._cond.notify_all()

    def _record_execute(self, rep: _Replica, key: _bk.BucketKey, batch, t0_pc: float,
                        **attrs) -> None:
        """Seen label + one execute span per traced request."""
        if metrics.is_on():
            with self._cond:
                self._seen_labels.add(key.label)
        if spans.is_on():
            t1 = spans.now()
            for r in batch:
                if r.trace is not None:
                    spans.record("execute", t0_pc, t1, trace=r.trace, parent=r.span,
                                 lane=rep.lane, bucket=key.label, batch=len(batch), **attrs)

    def _execute_batched(self, rep: _Replica, key: _bk.BucketKey, batch: List[_Request]):
        """Run one padded batch; returns ``(deliver, corrupt)``: the
        deferred per-item deliveries (resolved by _execute after the
        breaker bookkeeping) and the count of corrupt-result items."""
        if key.phase == "solve":
            return self._execute_solve_batched(rep, key, batch)
        self.cache.ensure_manifest(key, (1, self.batch_max))
        bb = _bk.batch_bucket(len(batch), self.batch_max)
        pads = [_bk.pad_request(key, r.A, r.B) for r in batch]
        while len(pads) < bb:  # repeat-pad to the fixed batch point
            pads.append(pads[0])
            metrics.inc("serve.batch_pad")
        A_b = np.stack([p[0] for p in pads])
        B_b = np.stack([p[1] for p in pads])
        t_exec = time.monotonic()
        t_exec_pc = spans.now() if spans.is_on() else 0.0
        X_b, info_b = self.cache.run(key, A_b, B_b, device=rep.device)
        now = time.monotonic()
        exec_s = now - t_exec
        self._record_execute(rep, key, batch, t_exec_pc)
        mon = metrics.is_on()
        deliver = []
        corrupt = 0
        for i, r in enumerate(batch):
            if mon:
                metrics.inc("serve.bucket_pad_waste", _bk.pad_waste(key, r.m, r.n, r.nrhs))
                metrics.observe_hist(f"serve.latency.{key.label}.execute", exec_s)
            late = r.deadline is not None and now > r.deadline
            info = int(info_b[i]) if i < len(info_b) else 0
            if info > 0:
                # the drivers' numerical contract (singular U, non-SPD):
                # deterministic, never retried
                if late:
                    self._miss_late(r)
                self._observe_total(rep, key.label, r, now)
                metrics.inc("serve.numerical_errors")
                deliver.append(functools.partial(
                    _resolve_exc, r.future, NumericalError(f"{r.routine}: info={info}", info), r))
                continue
            X = _bk.crop_result(key, X_b[i], r.n, r.nrhs)
            mixed = key.precision == "mixed"
            if (self.validate or mixed) and not np.all(np.isfinite(X)):
                # a non-finite X from finite inputs is a corrupted result
                # (or a mixed bucket's non-convergence signal): re-solve
                # this item direct rather than deliver garbage
                inputs_ok = self.validate or (np.all(np.isfinite(r.A))
                                              and np.all(np.isfinite(r.B)))
                if inputs_ok:
                    metrics.inc("serve.corrupt_result")
                    if mixed:
                        metrics.inc("serve.refine_demoted")
                    self._note_failure()
                    corrupt += 1
                deliver.append(functools.partial(self._direct, r))
                continue
            if late:
                self._miss_late(r)
            self._observe_total(rep, key.label, r, now)
            deliver.append(functools.partial(_resolve, r.future, X, r))
        if len(batch) > 1:
            metrics.inc("serve.batched")
            metrics.inc("serve.batched_requests", len(batch))
        return deliver, corrupt

    def _execute_solve_batched(self, rep: _Replica, key: _bk.BucketKey,
                               batch: List[_Request]):
        """The factor-cache hit path: one trsm-only batch against the
        cached factor on the device (same-fingerprint requests only).
        Only B is uploaded; gesv's P B is a gather on the device.  Every
        delivered item is residual-checked on the host: a finite wrong X
        drops the factor and re-solves through the factor path
        (``serve.factor_cache.stale``); a non-finite X keeps the full
        path's corrupt-result contract.  An entry evicted between
        admission and dispatch demotes every item to a counted refactor."""
        fc = self.factor_cache
        entry = fc.get(batch[0].factor_fp) if fc is not None else None
        if entry is None:
            # corrupt=None: the solve executable never ran, so a half-open
            # probe stays pending
            deliver = []
            for r in batch:
                _fc_record("refactor", fp=r.factor_fp)
                deliver.append(functools.partial(self._factor_direct, rep, r))
            return deliver, None
        self.cache.ensure_manifest(key, (1, self.batch_max))
        bb = _bk.batch_bucket(len(batch), self.batch_max)
        # factor_stale: a finite wrong factor, perturbed on its own device;
        # only the residual check below can catch it
        F = faults.perturb("factor_stale", entry.factor)
        Bs = [_bk.pad_rhs(np.asarray(r.B), key.m, key.nrhs) for r in batch]
        while len(Bs) < bb:  # repeat-pad to the fixed batch point
            Bs.append(Bs[0])
            metrics.inc("serve.batch_pad")
        t_exec = time.monotonic()
        t_exec_pc = spans.now() if spans.is_on() else 0.0
        B_b = torch.as_tensor(np.stack(Bs), device=rep.device)
        if entry.perm is not None:
            # P B on the device; the pad rows keep their place
            idx = torch.cat([entry.perm.to(rep.device),
                             torch.arange(entry.n, key.m, device=rep.device)])
            B_b = B_b[:, idx]
        X_b, _info_b = self.cache.run(key, F, B_b, device=rep.device)
        now = time.monotonic()
        exec_s = now - t_exec
        self._record_execute(rep, key, batch, t_exec_pc, factor_hit=True)
        mon = metrics.is_on()
        deliver = []
        corrupt = 0
        stale = False
        for i, r in enumerate(batch):
            if mon:
                metrics.inc("serve.bucket_pad_waste", _bk.pad_waste(key, r.m, r.n, r.nrhs))
                metrics.observe_hist(f"serve.latency.{key.label}.execute", exec_s)
            X = _bk.crop_result(key, X_b[i], r.n, r.nrhs)
            late = r.deadline is not None and now > r.deadline
            if not np.all(np.isfinite(X)):
                # a corrupted executable result: breaker failure + direct
                # re-solve; the cached factor is not implicated
                inputs_ok = self.validate or (np.all(np.isfinite(r.A))
                                              and np.all(np.isfinite(r.B)))
                if inputs_ok:
                    metrics.inc("serve.corrupt_result")
                    self._note_failure()
                    corrupt += 1
                deliver.append(functools.partial(self._direct, r))
                continue
            if not residual_ok(r.A, r.B, X, routine=r.routine):
                # finite but wrong: the factor no longer matches A
                _fc_record("stale", fp=entry.fp, label=entry.key.label)
                stale = True
                deliver.append(functools.partial(self._factor_direct, rep, r))
                continue
            _fc_record("hit", fp=entry.fp, label=entry.key.label)
            if r.span is not None:
                spans.annotate(r.span, factor_hit=True)
            if late:
                self._miss_late(r)
            self._observe_total(rep, key.label, r, now)
            deliver.append(functools.partial(_resolve, r.future, X, r))
        if stale:
            fc.invalidate(entry.fp)
        if len(batch) > 1:
            metrics.inc("serve.batched")
            metrics.inc("serve.batched_requests", len(batch))
        return deliver, corrupt

    def _factor_direct(self, rep: _Replica, req: _Request) -> None:
        """The factor-cache miss / refactor path: one direct factorization
        on the lane's device whose factor is captured (padded to the
        bucket, cached, its solve bucket registered in the manifest) and
        whose solve is the trsm-only sweep from it — O(n^3) once per
        distinct A.  Re-checks the cache first: in a same-A burst the
        first member factors and the rest find the entry (counted hits,
        under the same residual fence as the batched hit path)."""
        fc = self.factor_cache
        fp = req.factor_fp
        fkey = req.key
        if fkey is not None and fkey.phase != "full":
            fkey = dataclasses.replace(fkey, phase="full")
        entry = fc.get(fp) if (fc is not None and fp) else None
        cm = (spans.span("factor", trace=req.trace, parent=req.span, routine=req.routine)
              if req.trace is not None and spans.is_on() else contextlib.nullcontext())
        try:
            with cm:
                with metrics.phase(f"serve.factor.{req.routine}"):
                    faults.sleep("latency")
                    faults.check("execute")
                    X = None
                    if entry is not None:
                        X = solve_from_factor(entry, req.B)
                        if residual_ok(req.A, req.B, X, routine=req.routine):
                            _fc_record("hit", fp=fp, label=entry.key.label)
                            spans.annotate(factor_hit=True)
                        else:
                            _fc_record("stale", fp=fp, label=entry.key.label)
                            fc.invalidate(fp)
                            entry, X = None, None
                    if entry is None:
                        if req.routine == "gels":
                            factor = gels_factor_pack(req.A, fkey, schedule=self.schedule,
                                                      device=rep.device)
                            perm = None
                        else:
                            raw, perm = factor_only(req.routine, req.A,
                                                    schedule=self.schedule,
                                                    device=rep.device)
                            factor = pad_square_t(raw, fkey.n)
                        entry = FactorEntry(fp=fp, routine=req.routine, key=fkey,
                                            factor=factor, perm=perm, n=req.n)
                        if fc is not None and fp:
                            fc.put(entry, replica=rep.name)
                            # the hits to come ride the warmed manifest
                            self.cache.ensure_manifest(entry.solve_key, (1, self.batch_max))
                        X = solve_from_factor(entry, req.B)
                spans.annotate(outcome="ok")
        except Exception as e:  # noqa: BLE001 — futures carry the error
            _resolve_exc(req.future, e, req=req)
            return
        now = time.monotonic()
        if req.deadline is not None and now > req.deadline:
            self._miss_late(req)
        lbl = self._lat_label(req)
        if metrics.is_on():
            with self._cond:
                self._seen_labels.add(lbl)
        self._observe_total(rep, lbl, req, now)
        _resolve(req.future, X, req)

    @staticmethod
    def _lat_label(req: _Request) -> str:
        """Histogram label: the bucket label, or ``<routine>.direct``."""
        return req.key.label if req.key is not None else f"{req.routine}.direct"

    def _observe_total(self, rep: Optional[_Replica], label: str, req: _Request,
                       now: float) -> None:
        """Total (admit -> deliver) latency into the per-bucket and
        per-lane histograms, plus the deadline-budget burn tiers."""
        if not metrics.is_on():
            return
        total = now - req.t_submit
        metrics.observe_hist(f"serve.latency.{label}.total", total)
        if rep is not None:
            metrics.observe_hist(rep.lat_hist, total)
        if req.deadline is not None:
            budget = req.deadline - req.t_submit
            if budget > 0:
                burn = total / budget
                metrics.inc("serve.slo_burn.requests")
                if burn > 1.0:
                    metrics.inc("serve.slo_burn.exhausted")
                elif burn > 0.8:
                    metrics.inc("serve.slo_burn.over_80")
                elif burn > 0.5:
                    metrics.inc("serve.slo_burn.over_50")

    def _direct(self, req: _Request, batched_error: Optional[Exception] = None) -> None:
        """The direct driver on the lane's device: keyless requests, and
        the degradation fallback."""
        if req.key is not None:
            metrics.inc("serve.fallbacks")  # degradation, not routing
        else:
            metrics.inc("serve.direct_only")  # underdetermined gels
        cm = (spans.span("direct", trace=req.trace, parent=req.span, routine=req.routine)
              if req.trace is not None and spans.is_on() else contextlib.nullcontext())
        try:
            with cm:
                with metrics.phase(f"serve.direct.{req.routine}"):
                    X = direct_call(req.routine, req.A, req.B,
                                    device=self._replicas[0].device)
                spans.annotate(outcome="ok")
        except Exception as e:  # noqa: BLE001 — futures carry the error
            if batched_error is not None:
                e.__context__ = batched_error
            _resolve_exc(req.future, e, req=req)
            return
        now = time.monotonic()
        if req.deadline is not None and now > req.deadline:
            self._miss_late(req)
        lbl = self._lat_label(req)
        if metrics.is_on():
            with self._cond:
                self._seen_labels.add(lbl)
        self._observe_total(None, lbl, req, now)
        _resolve(req.future, X, req)


# -- delivery taps ----------------------------------------------------------
#
# Module-level observers of request resolution: ``tap(req, outcome)``
# is called where a request's future is about to resolve (outcome "ok"
# or the exception class name).  One truthiness check when none is
# registered; a tap never breaks delivery.

_delivery_taps: List[Callable[["_Request", str], None]] = []


def add_delivery_tap(fn: Callable[["_Request", str], None]) -> None:
    """Register a delivery observer (idempotent per function)."""
    if fn not in _delivery_taps:
        _delivery_taps.append(fn)


def remove_delivery_tap(fn: Callable[["_Request", str], None]) -> None:
    """Unregister a delivery observer (a missing fn is a no-op)."""
    try:
        _delivery_taps.remove(fn)
    except ValueError:
        pass


def _fire_delivery_taps(req: "_Request", outcome: str) -> None:
    for tap in list(_delivery_taps):
        try:
            tap(req, outcome)
        except Exception:  # noqa: BLE001 — observability never breaks delivery
            pass


def _finish_spans(req: Optional[_Request], outcome: str) -> None:
    """Close a request's span chain at resolution (first outcome wins)."""
    if req is None or req.span is None or not spans.is_on():
        return
    spans.end(req.qspan, outcome=outcome)
    spans.end(req.span, outcome=outcome)


def _resolve(fut: Future, value, req: Optional[_Request] = None) -> None:
    _finish_spans(req, "ok")
    if _delivery_taps and req is not None:
        _fire_delivery_taps(req, "ok")
    sync.hb_publish(fut)
    if not fut.done():
        fut.set_result(value)


def _resolve_exc(fut: Future, exc: Exception, req: Optional[_Request] = None) -> None:
    _finish_spans(req, type(exc).__name__)
    if _delivery_taps and req is not None:
        _fire_delivery_taps(req, type(exc).__name__)
    sync.hb_publish(fut)
    if req is not None and isinstance(exc, SlateError):
        exc.with_context(routine=req.routine,
                         bucket=req.key.label if req.key is not None else None,
                         attempt=req.attempt)
    if not fut.done():
        fut.set_exception(exc)
