"""SolverService: bounded admission, a replica pool, same-bucket batch
coalescing, a factor cache, deadlines, retries with backoff,
circuit-breaker recovery, the artifact restore, the integrity plane and
the admission plane and the device factor arena -- the JAX package's
``serve/service.py`` without the sharded lane (ROADMAP.md Queue 1 item
8) and the elastic capacity plane (item 7c2b).

Execution model:

* ``submit()`` validates (non-finite A/B -> immediate
  :class:`~slate_tpu_torch.exceptions.InvalidInput` before any queue or
  build cost; ``validate=False`` opts out), buckets the request
  (``buckets.bucket_for``) and enqueues it on a replica lane chosen by
  the placement policy (least-loaded or round-robin, excluding lanes
  whose breaker for the bucket is cooling down or that the integrity
  plane has quarantined).  A full service (the total queued across
  lanes at ``max_queue``) rejects immediately with :class:`Rejected`.
* Each lane's worker thread runs inside ``torch.cuda.device(lane
  device)``, so every launch lands on the lane's device and on that
  thread's current stream (on one H100 every lane pins ``cuda:0``).  It
  pops the oldest eligible request (one whose retry backoff has
  elapsed), waits up to ``batch_window_s`` for company, then coalesces
  every queued request with the same BucketKey (and factor
  fingerprint) up to ``batch_max`` into one batch padded to the fixed
  batch point (``buckets.batch_bucket``), so only two executables exist
  per bucket and a warmed steady state never makes a cold build.
* Supervision: every worker runs under a guard that catches any death
  (including the ``worker_death`` fault site), re-enqueues its
  in-flight requests that still have retry budget, fails the rest fast
  with a typed error, respawns itself and counts
  ``serve.worker_restarts`` — no future ever hangs.
* Deadlines: a request whose deadline passes while queued is cancelled
  with :class:`DeadlineExceeded` (``serve.deadline_miss_queued``); one
  that finishes late is delivered and counted
  (``serve.deadline_miss_late``); ``serve.deadline_miss`` is the sum.
* Failures: an executable exception re-enqueues the batch's requests on
  their lane while they have ``retries`` left, each delayed by
  decorrelated-jitter backoff (:func:`decorrelated_backoff`, seeded);
  past the budget each falls back to the direct driver
  (``serve.fallbacks``).  A kernel that fails to build or launch takes
  this chain too; nothing moves to the CPU.
* Circuit breaker (``buckets.Breaker``, per BucketKey per lane):
  ``degrade_after`` consecutive batched failures open it (the lane's
  requests go direct and admission steers new ones to healthy lanes),
  after ``breaker_cooldown_s`` it half-opens and the next batch probes;
  one healthy probe closes it.
* A nonzero per-item ``info`` raises
  :class:`~slate_tpu_torch.exceptions.NumericalError` on that item only;
  a non-finite solution for finite inputs (``result_corrupt``) is
  re-solved direct, counted ``serve.corrupt_result``.
* Factor cache (``serve/factor_cache.py``, off by default): eligible
  requests are fingerprinted at admission; a hit dispatches the
  trsm-only ``phase="solve"`` bucket against the cached factor (routed
  to the lane that owns it, or to a healthy lane while the owner's
  solve bucket cools down), a miss factors once through the drivers and
  caches the factor.  Every hit is residual-checked on the host: a
  factor that no longer matches A (``factor_stale``) is dropped and the
  request re-solved, never a wrong X.
* Device factor arena (``fabric/arena.py``, off by default:
  ``factor_arena=`` / ``SLATE_TPU_FACTOR_ARENA`` /
  ``Option.ServeFactorArena``, with the factor cache on): the cache
  keeps its factors in pinned host memory (a miss factors on the lane's
  device, solves there, and stores a host copy), and a hit dispatches
  the lane's resident device buffer, uploading it once on the lane's
  first hit.  Spill, eviction and invalidation free device memory; the
  next hit re-uploads, never refactors.  Chaos bypasses the arena.  Off,
  ``self.arena is None`` and the hit path is the one above.
* Readiness (``health()["phase"]``: ``cold`` -> ``restoring`` ->
  ``ready``): a service whose cache has an artifact store
  (``SLATE_TPU_ARTIFACTS``) restores every manifest entry on
  :meth:`start` in a background thread, priming every lane's device,
  before it reports ``ready`` (:meth:`wait_ready`).  Requests submitted
  while restoring are still served.
* Replica pool: :meth:`add_replica` brings a lane live warm (its device
  primed through ``ExecutableCache.prime`` before its worker spawns);
  :meth:`remove_replica` takes a lane out of admission, re-homes its
  queue to the survivors and drains its worker.  Lane names are
  monotonic and never reused; removed lanes keep a terminal row in
  ``health()["replicas"]``.
* Integrity plane (``slate_tpu_torch/integrity``, off by default): with
  an ``integrity=`` / ``SLATE_TPU_INTEGRITY`` / ``Option.ServeIntegrity``
  policy, delivered gesv/posv solves are certified (the residual fence,
  or the checksum relation for ABFT buckets, whose cores also fold an
  on-device verdict into ``info``).  A failed certificate never reaches
  the client: the request re-executes, hedged to another lane when one
  exists.  Each lane's :class:`IntegrityScore` quarantines it at
  admission after repeated failures and probes it back; queued
  requests older than their bucket's p99 are duplicated onto a second
  lane, first correct result wins.
* Admission plane (``serve/admission.py``, off by default): with a
  tenant spec (``tenants=`` / ``SLATE_TPU_TENANTS`` /
  ``Option.ServeTenantQuota``) or the adaptive window (``adaptive=`` /
  ``SLATE_TPU_ADAPTIVE`` / ``Option.ServeAdaptiveWindow``) each request
  carries ``tenant`` / ``priority``; the lane queues become per-tenant
  weighted-fair queues, token-bucket quotas and queue-share caps make
  :class:`Rejected` per-tenant, the overload controller refuses
  lowest-priority-first with a typed :class:`Shed` under sustained
  deadline burn, and an AIMD controller sets each bucket's coalesce
  window against ``latency_budget_s``.  Off, the service pays one
  ``is None`` branch a submit and keeps plain deque lanes.
* Race plane (``aux/sync``, ``SLATE_TPU_SYNC_CHECK``): the service's
  locks come from the checked factories and its ``# guarded by:``
  fields carry lockset probes; off, they are plain ``threading``
  objects and one bool a probe.

Results are numpy arrays: the copy to the host is a dispatch's
synchronisation point, and ``info`` is read once an item.  Every
exception set on a future carries ``routine``/``bucket``/``attempt``
context (:meth:`SlateError.with_context`).

Metrics (JAX package names): ``serve.queue_depth``,
``serve.replica.<i>.{queue_depth,dispatched,oldest_queued_s,breaker_open,
breaker_closed,quarantined,unquarantined,removed}``, ``serve.requests``,
``serve.replicated_dispatch``, ``serve.batched``,
``serve.batched_requests``, ``serve.batch_pad``,
``serve.bucket_pad_waste``, ``serve.deadline_miss`` (+ ``_queued`` /
``_late``), ``serve.rejected``, ``serve.invalid_input``,
``serve.retries`` + the ``serve.retry_backoff_s`` timer,
``serve.fallbacks``, ``serve.direct_only``, ``serve.worker_restarts``,
``serve.breaker_open`` / ``half_open`` / ``closed`` (and
``serve.degraded``), ``serve.numerical_errors``,
``serve.corrupt_result``, ``serve.factor_cache.*``,
``serve.integrity.{checked,fail,recovered,abandoned,quarantined,
unquarantined}``, ``serve.hedge.{sent,won,wasted}``,
``serve.restore_crashed``, the admission plane's ``serve.shed``,
``serve.rejected_quota`` / ``serve.rejected_share``, the capped
``serve.tenant.<id>.{admitted,shed,rejected,slo_burn.*}`` and
``serve.latency.tenant.<id>.total`` (``serve.tenant_overflow`` past the
cap), ``serve.overload.{level,enter,exit}`` and
``serve.adaptive.<bucket>.{window_s,widen,shrink}``,
``serve.adaptive.changes``, the device monitor's
``serve.device.<i>.bytes_in_use[_peak]``, ``scale.replicas_added`` /
``scale.replicas_removed`` / ``scale.requests_rehomed`` /
``scale.prime_*``, the ``serve.latency.<bucket>.{queued,execute,total}``
and ``serve.latency.replica.<i>.total`` histograms, and the
``serve.slo_burn.*`` tiers.  With ``aux/spans`` on, every request
carries a trace id and a ``request`` -> ``admit``/``queued``/
``coalesce``/``execute`` | ``direct``/``factor``/``backoff`` chain.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import random
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Union

import numpy as np
import torch

from ..aux import devmon, faults, metrics, spans, sync
from ..exceptions import InvalidInput, NumericalError, SlateError
from ..integrity import abft as _abft
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
    host_entry,
    matrix_fingerprint,
    pad_square_t,
    residual_ok,
    solve_from_factor,
)
from .factor_cache import record as _fc_record
from .placement import PlacementPolicy


class Rejected(SlateError):
    """Queue-full backpressure: the request was never admitted.  On a
    tenancy-enabled service it is per-tenant: a token-bucket quota or
    queue-share violation rejects the hot tenant's request while its
    neighbours keep being admitted."""


class DeadlineExceeded(SlateError):
    """The request's deadline passed before execution started."""


class Shed(SlateError):
    """Load shed under sustained overload: the burn EWMA crossed a shed
    tier and this request's priority class is refused at admission
    (lowest-priority-first, ``admission.OverloadController``).  Unlike
    :class:`Rejected` the queue may have room; back off and retry, or
    resubmit at a higher priority."""


#: ceiling for one decorrelated-jitter backoff step, seconds
BACKOFF_CAP_S = 2.0

#: readiness phases (health()["phase"]): cold = constructed; restoring =
#: the start-time restore pass is running; ready = it finished (or there
#: was nothing to restore)
PHASE_COLD = "cold"
PHASE_RESTORING = "restoring"
PHASE_READY = "ready"

#: lane states (health()["replicas"]): draining = remove_replica() is
#: quiescing the lane; removed = gone (the row stays)
LANE_LIVE = "live"
LANE_DRAINING = "draining"
LANE_REMOVED = "removed"


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
    # admission-plane identity (defaults when the plane is off; tenanted
    # marks a request admitted through the plane, so error context and
    # the control loop engage only where tenancy is real)
    tenant: str = _bk.DEFAULT_TENANT
    priority: int = _bk.PRIO_NORMAL
    tenanted: bool = False
    # factor cache: fingerprint of A, and whether admission missed (the
    # request factors through _factor_direct instead of the batched path)
    factor_fp: Optional[str] = None
    factor_miss: bool = False
    # integrity plane (defaults when off): certificate failures so far,
    # whether the current re-execution was hedged to another lane, and
    # (straggler hedging) whether this request is the duplicate and the
    # first-result-wins pairing it shares with its twin
    cert_fails: int = 0
    reexec_hedged: bool = False
    is_hedge: bool = False
    hedge_group: Optional["_HedgeGroup"] = None
    # tracing (all None when spans are off): trace id, root span, the
    # live "queued" span
    trace: Optional[str] = None
    span: Optional[spans.Span] = None
    qspan: Optional[spans.Span] = None

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic()) > self.deadline)


class _HedgeGroup:
    """First-correct-result-wins pairing of a straggler and its hedge
    (Dean & Barroso, "The Tail at Scale"): the twins share one Future;
    whichever lane delivers first resolves it, the loser's work counts
    ``serve.hedge.wasted``, and an exception resolves the future only
    once every member has failed."""

    def __init__(self, members: int = 2):
        self.lock = sync.Lock(name="service._HedgeGroup.lock")
        self.members = members
        self.delivered = False  # guarded by: lock
        self.failed = 0  # guarded by: lock

    def first_result(self) -> bool:
        """Claim the win; False when a twin already delivered."""
        with self.lock:
            sync.guarded(self, "delivered")
            if self.delivered:
                return False
            self.delivered = True
            return True

    def member_failed(self) -> bool:
        """Record one member's failure; True when it was the last live
        member and nothing delivered (only then may the caller set the
        exception)."""
        with self.lock:
            sync.guarded(self, "failed")
            self.failed += 1
            return not self.delivered and self.failed >= self.members


class _Replica:
    """One serving lane: a queue, a supervised worker, per-bucket
    breakers, the device its dispatches run on and (integrity plane on)
    its quarantine score.  Its mutable state is owned by the service's
    condition lock."""

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.device = device
        self.score: Optional[_integ.IntegrityScore] = None  # self-locked
        # a plain deque, or the admission plane's FairQueue (same surface)
        self.q: Deque[_Request] = deque()  # guarded by: _cond
        self.inflight: List[_Request] = []  # guarded by: _cond
        self.breakers: Dict[_bk.BucketKey, _bk.Breaker] = {}  # guarded by: _cond
        # remove_replica() sets it; the worker loop exits on it
        self.stopping = False  # guarded by: _cond
        self.thread: Optional[threading.Thread] = None
        self.restarts = 0
        self.dispatched = 0
        self.q_gauge = f"serve.replica.{name}.queue_depth"
        self.dispatched_counter = f"serve.replica.{name}.dispatched"
        self.oldest_gauge = f"serve.replica.{name}.oldest_queued_s"
        self.quar_counter = f"serve.replica.{name}.quarantined"
        self.unquar_counter = f"serve.replica.{name}.unquarantined"
        self.removed_counter = f"serve.replica.{name}.removed"
        self.lat_hist = f"serve.latency.replica.{name}.total"
        self.lane = f"replica-{name}"

    def alive(self) -> bool:
        return bool(self.thread is not None and self.thread.is_alive())


class SolverService:
    """Batching solver service over the driver stack.

    Parameters (the JAX package's; None reads the Serve* Option default)
    ----------
    cache: :class:`ExecutableCache` (built from ``SLATE_TPU_WARMUP`` and
        ``Option.ServeArtifacts`` / ``SLATE_TPU_ARTIFACTS`` when omitted).
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
    placement: :class:`PlacementPolicy` — its replica lanes pin
        ``cuda:0`` unless its ``devices`` name others (the tests pass the
        CPU).
    replicas: shorthand for ``placement.replicas`` when no explicit
        policy is passed.
    factor_cache: :class:`FactorCache`, or None to resolve
        ``SLATE_TPU_FACTOR_CACHE`` / ``Option.ServeFactorCache*`` (off
        by default), or False to disable it over the env.
    factor_arena: :class:`~slate_tpu_torch.fabric.arena.FactorArena`,
        or None to resolve ``SLATE_TPU_FACTOR_ARENA`` /
        ``Option.ServeFactorArena`` (off by default), or False to
        disable it over the env; None without a factor cache.
    tenants: the admission plane's tenant spec (the grammar string of
        ``serve/admission.py``, e.g. ``"gold:weight=4;free:rate=20,
        share=0.25"``, or a parsed ``{name: TenantConfig}``); None
        resolves ``Option.ServeTenantQuota`` then ``SLATE_TPU_TENANTS``.
        Any tenant turns the plane on: weighted-fair lanes, per-tenant
        quotas and queue shares, priority shedding.
    adaptive: the AIMD coalesce window (ceiling ``batch_window_s``);
        None resolves ``Option.ServeAdaptiveWindow`` then
        ``SLATE_TPU_ADAPTIVE``.
    latency_budget_s: the service-wide p99 budget the controllers judge
        requests without a deadline against (``Option.ServeLatencyBudget``
        or the ``SLATE_TPU_ADAPTIVE`` budget when None).
    integrity: :class:`~slate_tpu_torch.integrity.policy.IntegrityPolicy`,
        a spec string (``off | sample=<p> | full`` with ``,abft`` and
        tuning keys), or False to disable it over the env; None resolves
        ``SLATE_TPU_INTEGRITY`` then ``Option.ServeIntegrity`` (off by
        default: one ``is None`` branch a delivery).
    faults_spec: aux/faults grammar; arms and enables injection, which
        the service owns and disarms on :meth:`stop`.
    restore_on_start: run the cache's restore pass in a background thread
        on :meth:`start` (phase ``restoring`` until it ends); None =
        exactly when the cache has an artifact store.
    restore_stuck_after_s: past this age a still-restoring phase is
        reported in ``health()["restore_stuck_s"]``.
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
        factor_arena=None,
        tenants=None,
        adaptive: Optional[bool] = None,
        latency_budget_s: Optional[float] = None,
        integrity=None,
        faults_spec: Optional[str] = None,
        restore_on_start: Optional[bool] = None,
        restore_stuck_after_s: float = 60.0,
        start: bool = True,
    ):
        from ..enums import Option, Schedule
        from ..options import get_option

        def opt(value, key):
            return value if value is not None else get_option(None, key)

        self.placement = (placement if placement is not None
                          else PlacementPolicy.from_options(replicas=replicas))
        lane_devices = self.placement.replica_devices()  # raises without a device
        self.cache = (cache if cache is not None else ExecutableCache(
            artifact_dir=get_option(None, Option.ServeArtifacts) or None))
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
        # the device factor arena (fabric/): None unless armed, and
        # meaningless without the host cache; the fabric package is
        # imported only when something arms it
        self.arena = None
        if factor_arena is not False and self.factor_cache is not None:
            if factor_arena is not None:
                self.arena = factor_arena
            elif os.environ.get("SLATE_TPU_FACTOR_ARENA") or get_option(
                    None, Option.ServeFactorArena):
                from ..fabric.arena import arena_from_options

                self.arena = arena_from_options()
        # the admission plane (tenancy, priority shedding, the adaptive
        # window): None unless configured -- one `is None` branch a
        # submit, plain deque lanes
        self._admission = _adm.AdmissionControl.from_options(
            tenants=tenants, adaptive=adaptive, budget_s=latency_budget_s,
            ceiling_s=self.batch_window_s)
        # the integrity plane: None unless configured (one `is None`
        # branch a delivery and a sweep)
        self._integrity = _integ.from_options(integrity)
        if faults_spec is None:
            faults_spec = get_option(None, Option.Faults) or ""
        # injection is process-global; the arming service disarms on stop()
        self._owns_faults = bool(faults_spec)
        if faults_spec:
            faults.configure(faults_spec)
            faults.on()
        self._restore_on_start = restore_on_start
        self._phase = PHASE_COLD
        self._restore_result: Optional[Dict[str, int]] = None
        self._restore_thread: Optional[threading.Thread] = None
        self.restore_stuck_after_s = float(restore_stuck_after_s)
        self._restore_started: Optional[float] = None
        self._rng = random.Random(retry_seed)
        self._cond = sync.Condition(name="service.SolverService._cond")
        self._running = False
        self._stopped = False  # stop() called; submit() rejects until start()
        self._replicas: List[_Replica] = [_Replica(str(i), d)
                                          for i, d in enumerate(lane_devices)]
        if self._admission is not None:
            for rep in self._replicas:
                rep.q = self._admission.new_queue()
        if self._integrity is not None:
            for rep in self._replicas:
                rep.score = self._integrity.new_score()
        self._hedge_last_sweep = 0.0  # guarded by: _cond
        # lane names are monotonic ordinals, never reused; removed lanes
        # keep a terminal row
        self._next_replica = len(self._replicas)  # guarded by: _cond
        self._terminal: "OrderedDict[str, dict]" = OrderedDict()  # guarded by: _cond
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
            self._cond.notify_all()
        _load_cuda_linalg([rep.device for rep in self._replicas])
        for rep in self._replicas:
            self._spawn_worker(rep)
        self._begin_restore()
        return self

    def _begin_restore(self) -> None:
        """Start the one-time restore pass (cold -> restoring -> ready).
        A stop()/start() cycle keeps an already-ready phase."""
        want = (self._restore_on_start if self._restore_on_start is not None
                else self.cache.artifacts is not None)
        with self._cond:
            if self._phase != PHASE_COLD:
                return
            if not want:
                self._phase = PHASE_READY
                self._cond.notify_all()
                return
            self._phase = PHASE_RESTORING
            self._restore_started = time.monotonic()
            t = threading.Thread(target=self._run_restore, name="slate-serve-restore",
                                 daemon=True)
            self._restore_thread = t
        t.start()

    def restore(self, verbose: bool = False, stop_check=None) -> Dict[str, int]:
        """The cache's restore pass for this service's lanes (every lane
        device primed); returns its summary.  The start-time pass and
        ``serve.restore()`` both call it."""
        return self.cache.restore(batch_max=self.batch_max, stop_check=stop_check,
                                  devices=self.placement.replica_devices(), verbose=verbose)

    def _run_restore(self) -> None:
        try:
            result = self.restore(stop_check=lambda: self._stopped)
        except Exception:  # noqa: BLE001 — a broken store must not block ready
            metrics.inc("serve.restore_crashed")
            result = {"entries": 0, "restored": 0, "compiled": 0, "failed": 0,
                      "skipped": 0, "crashed": True}
        with self._cond:
            self._restore_result = result
            self._phase = PHASE_READY
            self._cond.notify_all()

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the phase reaches ``ready`` (True) or ``timeout``
        elapses (False).  A service built paused and never started
        returns False at once: nothing will advance its phase."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        with self._cond:
            while self._phase != PHASE_READY:
                if not self._running and self._phase == PHASE_COLD:
                    return False
                left = deadline - time.monotonic() if deadline is not None else 0.1
                if deadline is not None and left <= 0:
                    return False
                self._cond.wait(min(left, 0.1) if left > 0 else 0.1)
            return True

    def warmup(self, path: Optional[str] = None, verbose: bool = False) -> int:
        """Cold-build the manifest's executables on every lane's device;
        returns the number built."""
        return self.cache.warmup(path=path, batch_max=self.batch_max,
                                 devices=self.placement.replica_devices(), verbose=verbose)

    def _spawn_worker(self, rep: _Replica) -> None:
        t = threading.Thread(target=self._run_worker, args=(rep,),
                             name=f"slate-serve-worker-{rep.name}", daemon=True)
        with self._cond:
            # started before the lock is released: stop() and
            # remove_replica() join what they read here, and joining a
            # thread that has not started raises
            t.start()
            rep.thread = t

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
                sync.guarded(rep, "q")
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
            rt = self._restore_thread
        # the restore thread polls _stopped between entries; a bounded
        # join so faults.reset() below never runs under a live pass
        if rt is not None and rt.is_alive():
            rt.join(max(0.0, deadline - time.monotonic()))
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

    # -- the replica pool ----------------------------------------------------

    def _rehome_queue_locked(self, rep: _Replica) -> int:
        """Move every request queued on ``rep`` (already out of
        ``self._replicas``) to the surviving lanes; caller holds
        ``_cond``.  Returns the count moved."""
        pending = list(rep.q)
        if not pending:
            return 0
        rep.q.clear()
        for r in pending:
            tgt = self._pick_replica_locked(r.key)
            sync.guarded(tgt, "q")
            tgt.q.append(r)
        metrics.inc("scale.requests_rehomed", len(pending))
        metrics.gauge(rep.q_gauge, 0)
        self._gauge_queues_locked()
        self._cond.notify_all()
        return len(pending)

    def _prime_lane(self, rep: _Replica) -> Dict[str, int]:
        """Warm a joining lane's device before it takes traffic: the whole
        manifest through ``ExecutableCache.prime``, artifact-first."""
        counts = self.cache.prime(devices=[rep.device], batch_max=self.batch_max,
                                  stop_check=lambda: self._stopped)
        for k in ("restored", "compiled", "failed", "skipped"):
            if counts.get(k):
                metrics.inc(f"scale.prime_{k}", counts[k])
        return counts

    def add_replica(self, warm: bool = True) -> str:
        """Bring one new lane live; ``warm`` primes its device through
        the manifest first, so its first steady-state request makes no
        cold build.  Returns the lane's name (a monotonic ordinal, never
        reused).  Raises RuntimeError when the service is not running."""
        with self._cond:
            if self._stopped or not self._running:
                raise RuntimeError("add_replica: service is not running")
            name = str(self._next_replica)
            self._next_replica += 1
            idx = len(self._replicas)
            self.placement.set_replicas(idx + 1)
            device = self.placement.device_for(idx)
        rep = _Replica(name, device)
        _load_cuda_linalg([device])
        warmed: Dict[str, int] = {}
        if warm:
            # outside _cond: priming runs the cores
            warmed = self._prime_lane(rep)
        with self._cond:
            if self._stopped or not self._running:
                self.placement.set_replicas(len(self._replicas))
                raise RuntimeError("add_replica: service stopped while priming")
            if self._admission is not None:
                rep.q = self._admission.new_queue()
            if self._integrity is not None:
                rep.score = self._integrity.new_score()
            self._replicas.append(rep)
            self.placement.set_replicas(len(self._replicas))
            fleet = len(self._replicas)
            self._cond.notify_all()
        self._spawn_worker(rep)
        metrics.inc("scale.replicas_added")
        metrics.gauge("scale.fleet", fleet)
        spans.event("replica_added", lane=rep.lane, restored=warmed.get("restored", 0),
                    compiled=warmed.get("compiled", 0))
        return name

    def remove_replica(self, name: Optional[str] = None, drain_timeout: float = 30.0) -> str:
        """Take one lane (default: the newest) out of admission, re-home
        its queue to the survivors, let its worker finish its in-flight
        batch (bounded by ``drain_timeout``) and re-home its factor-cache
        entries.  Its health row moves to the terminal table (draining ->
        removed).  Raises ValueError for the last lane or an unknown
        name."""
        with self._cond:
            if len(self._replicas) <= 1:
                raise ValueError("remove_replica: cannot remove the last lane")
            if name is None:
                rep = self._replicas[-1]
            else:
                rep = next((r for r in self._replicas if r.name == name), None)
                if rep is None:
                    raise ValueError(f"remove_replica: no lane named {name!r}")
            self._replicas.remove(rep)
            self.placement.set_replicas(len(self._replicas))
            sync.guarded(rep, "stopping")
            rep.stopping = True
            self._terminal[rep.name] = {
                "name": rep.name, "state": LANE_DRAINING, "device": str(rep.device),
                "dispatched": rep.dispatched, "restarts": rep.restarts}
            moved = self._rehome_queue_locked(rep)
            self._cond.notify_all()
            t = rep.thread
            survivor = self._replicas[0]
        spans.event("drain", lane=rep.lane, rehomed=moved)
        if t is not None:
            t.join(max(float(drain_timeout), 0.0))
        # outside _cond: the factor cache is self-locked
        refactored = (self.factor_cache.rehome(rep.name, survivor.name)
                      if self.factor_cache is not None else 0)
        if self.arena is not None:
            # residency is lane-affine: the survivors re-upload on a hit
            self.arena.drop_lane(rep.lane)
        with self._cond:
            # anything that still landed here (a requeue racing the join)
            self._rehome_queue_locked(rep)
            if rep.thread is t:
                rep.thread = None
            row = self._terminal.get(rep.name, {"name": rep.name})
            row.update({"state": LANE_REMOVED, "dispatched": rep.dispatched,
                        "restarts": rep.restarts, "factor_rehomed": refactored,
                        "drain_timed_out": bool(t is not None and t.is_alive())})
            self._terminal[rep.name] = row
            while len(self._terminal) > 64:  # a bounded terminal table
                self._terminal.popitem(last=False)
            fleet = len(self._replicas)
        metrics.inc("scale.replicas_removed")
        metrics.inc(rep.removed_counter)
        metrics.gauge("scale.fleet", fleet)
        metrics.gauge(rep.q_gauge, 0)
        metrics.gauge(rep.oldest_gauge, 0.0)
        if refactored:
            metrics.inc("scale.factors_rehomed", refactored)
        spans.event("replica_removed", lane=rep.lane, factor_rehomed=refactored)
        return rep.name

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
        for gesv/posv.  ``sharded=True`` raises (no mesh).  ``tenant`` /
        ``priority`` ("high" | "normal" | "low", default "normal") tag the
        request for the admission plane (inert, but validated, when the
        plane is off).  Raises :class:`Rejected` when the queue (or, tenancy
        on, this tenant's quota or queue share) is full, :class:`Shed` when
        the overload controller refuses this priority class, and
        :class:`InvalidInput` on non-finite operands."""
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
                _root: Optional[spans.Span] = None, _synthetic: bool = False) -> Future:
        adm = self._admission
        # one normaliser for both plane states: a tag the plane would
        # refuse fails the same way with the plane off
        tname, prio = _adm.resolve_identity(tenant, priority)
        A = np.asarray(A)
        B = np.asarray(B)
        if B.ndim == 1:
            B = B[:, None]
        if A.ndim != 2 or B.ndim != 2 or A.shape[0] != B.shape[0]:
            raise ValueError(f"{routine}: bad shapes A{A.shape} B{B.shape}")
        if adm is not None:
            # the admission plane, before the O(n^2) finiteness scan: a
            # refusal under overload must cost O(1)
            if not _synthetic and adm.tenancy and faults.is_on():
                # tenant_flood: a synthetic low-priority burst from tenant
                # "flood" cloning this request (tenancy-gated: on an
                # adaptive-only plane the burst would admit wholesale)
                s = faults.fire("tenant_flood")
                if s is not None:
                    self._flood_burst(routine, A, B, s.burst)
            # anti-latch: an idle EWMA decays before the shed decision
            adm.tick(time.monotonic())
            if adm.sheds(prio):
                adm.tenant_event(tname, "shed")
                metrics.inc("serve.shed")
                # the level is read without the plane's lock: a stale
                # value in a span attr or a message is harmless, and the
                # refusal path stays O(1)
                level = adm.overload.level
                if spans.is_on():
                    spans.event("shed", trace=_trace, lane="client", tenant=tname,
                                priority=_bk.priority_name(prio), level=level)
                raise Shed(f"{routine}: overload level {level} is shedding "
                           f"{_bk.priority_name(prio)}-priority traffic; back off or "
                           "raise priority").with_context(
                    routine=routine, tenant=tname, priority=_bk.priority_name(prio))
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
        # ABFT bucket routing: with the integrity plane's abft flag on,
        # eligible requests bucket under tag="abft" (the checksummed
        # cores).  Excluded with the factor cache on: its traffic keeps
        # the residual-fenced hit path and the certified miss path
        use_abft = (self._integrity is not None and self._integrity.abft
                    and self.factor_cache is None and routine in ("gesv", "posv")
                    and prec == "full")
        key: Optional[_bk.BucketKey] = None
        if not (routine == "gels" and m < n):
            key = _bk.bucket_for(routine, m, n, nrhs, A.dtype, floor=self.dim_floor,
                                 nrhs_floor=self.nrhs_floor, schedule=self.schedule,
                                 precision=prec, tag=_abft.ABFT_TAG if use_abft else "")
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
            retries=int(retries), tenant=tname, priority=prio, tenanted=adm is not None,
            factor_fp=fp, factor_miss=bool(fp is not None and hit is None), trace=_trace,
            span=_root,
        )
        if _root is not None:
            spans.annotate(_root, bucket=key.label if key is not None else None,
                           sharded=False)
            if adm is not None:
                spans.annotate(_root, tenant=tname, priority=_bk.priority_name(prio))
        pname = _bk.priority_name(prio) if adm is not None else None
        with self._cond:
            if self._stopped:
                metrics.inc("serve.rejected")
                raise Rejected("service stopped; configure() a new one"
                               ).with_context(routine=routine)
            if sum(len(rep.q) for rep in self._replicas) >= self.max_queue:
                metrics.inc("serve.rejected")
                if adm is not None:
                    adm.tenant_event(tname, "rejected")
                raise Rejected(f"queue full ({self.max_queue}); retry with backoff"
                               ).with_context(routine=routine,
                                              tenant=tname if adm is not None else None,
                                              priority=pname)
            if adm is not None and adm.config_for(tname).share < 1.0:
                # the per-tenant queue-share cap: a bursty tenant fills its
                # slice of the bounded queue, not its neighbours'
                limit = adm.share_limit(tname, self.max_queue)
                if sum(rep.q.depth(tname) for rep in self._replicas) >= limit:
                    metrics.inc("serve.rejected")
                    metrics.inc("serve.rejected_share")
                    adm.tenant_event(tname, "rejected")
                    raise Rejected(f"tenant {tname!r} queue share full ({limit} of "
                                   f"{self.max_queue}); retry with backoff").with_context(
                        routine=routine, tenant=tname, priority=pname)
            if adm is not None and not adm.quota_take(tname, time.monotonic()):
                # the token bucket is the last check: only a request that is
                # admitted consumes a token, so refusals caused by others (a
                # full shared queue) never drain this tenant's quota
                adm.tenant_event(tname, "rejected")
                metrics.inc("serve.rejected")
                metrics.inc("serve.rejected_quota")
                raise Rejected(f"tenant {tname!r} token-bucket quota exhausted "
                               f"({adm.config_for(tname).rate:g}/s); retry with backoff"
                               ).with_context(routine=routine, tenant=tname, priority=pname)
            rep = self._pick_replica_locked(key)
            if hit is not None:
                # a hit routes to the lane that owns the factor, unless
                # that lane's solve bucket is cooling down: then a healthy
                # selected lane serves the same factor through its own
                # solve bucket (cross-lane hit), or, with no healthy
                # other lane, the request spills off the batched solve
                # executable onto the direct factor path — never a
                # dispatch into a known-sick path
                own = next((r for r in self._replicas if r.name == hit.replica), None)
                if own is not None:
                    now_cl = time.monotonic()
                    b = own.breakers.get(key)
                    if b is not None and b.cooling_down(now_cl, self.breaker_cooldown_s):
                        alt_b = rep.breakers.get(key)
                        if rep is not own and not (
                                alt_b is not None
                                and alt_b.cooling_down(now_cl, self.breaker_cooldown_s)):
                            _fc_record("cross_lane_hit", fp=fp, label=key.label)
                        else:
                            _fc_record("spill", fp=fp, label=full_key.label)
                            req.key = key = full_key
                            req.factor_miss = True
                    else:
                        rep = own
            if _root is not None:
                req.qspan = spans.start("queued", trace=_trace, parent=_root,
                                        lane=rep.lane)
            sync.guarded(rep, "q")
            rep.q.append(req)
            self._gauge_queues_locked()
            self._cond.notify_all()
        if key is not None:
            metrics.inc("serve.replicated_dispatch")
        metrics.inc("serve.requests")
        if adm is not None:
            adm.tenant_event(tname, "admitted")
        return req.future

    def _flood_burst(self, routine: str, A, B, count: int) -> None:
        """The ``tenant_flood`` fault site: ``count`` synthetic
        low-priority requests from tenant ``"flood"`` cloning the
        triggering request, each through the normal admission path (no
        recursive flood check), so quota rejections and sheds are counted
        where they happen; admitted ones resolve like any other."""
        for _ in range(max(int(count), 0)):
            try:
                self._submit(routine, A, B, retries=0, tenant="flood", priority="low",
                             _synthetic=True)
            except SlateError:
                pass  # shed or rejected: the point, counted at the raise

    def _pick_replica_locked(self, key: Optional[_bk.BucketKey]) -> _Replica:
        """Admission-side lane selection through the placement policy,
        excluding lanes quarantined and cooling down (integrity plane)
        and lanes whose breaker for this bucket is cooling down, while a
        healthy lane exists."""
        if len(self._replicas) == 1:
            return self._replicas[0]
        loads = [len(r.q) + len(r.inflight) for r in self._replicas]
        now = time.monotonic()
        flags = None
        if self._integrity is not None:
            flags = [r.score is not None and r.score.excluded(now) for r in self._replicas]
        if key is not None:
            br = []
            for r in self._replicas:
                b = r.breakers.get(key)
                br.append(b is not None and b.cooling_down(now, self.breaker_cooldown_s))
            flags = br if flags is None else [a or b for a, b in zip(flags, br)]
        return self._replicas[self.placement.select_replica(loads, flags)]

    def queue_depth(self) -> int:
        with self._cond:
            return sum(len(rep.q) for rep in self._replicas)

    # -- health ------------------------------------------------------------

    def health(self) -> dict:
        """Liveness/readiness snapshot: queue depth vs limit, the
        readiness phase and the restore summary, per-lane worker
        liveness, restarts, dispatch counts, breaker states and the age
        of the oldest queued request (``replicas``, removed lanes
        included with their terminal state), the integrity plane's
        policy and per-lane quarantine scores (``integrity``, None when
        off), the admission plane's per-tenant depth / quota / counts /
        burn (``tenants``) and controller state (``admission``; both None
        when off), the recent failure rate (last 60 s) and, with metrics
        on, per-bucket p50/p95/p99 total latency (``latency``) and the
        deadline-budget burn tiers (``slo_burn``).  With tracing on, the
        span ring's eviction pressure (``trace_ring``); with the device
        monitor on, the cost rows by bucket (``cost``), each latency row's
        ``peak_bytes`` and a memory snapshot of each lane device
        (``devices``; None byte fields on the CPU).  The top-level
        ``breakers`` map merges the lanes' tables, worst state wins."""
        now = time.monotonic()
        window_s = 60.0
        rank = {_bk.BREAKER_OPEN: 2, _bk.BREAKER_HALF_OPEN: 1, _bk.BREAKER_CLOSED: 0}
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
                for lbl, st in states.items():
                    if rank[st] > rank.get(merged.get(lbl), -1):
                        merged[lbl] = st
                lanes.append({
                    "name": rep.name, "state": LANE_LIVE, "device": str(rep.device),
                    "queue_depth": len(rep.q), "inflight": len(rep.inflight),
                    "oldest_queued_s": (now - min(r.t_submit for r in rep.q)) if rep.q
                    else 0.0,
                    "worker_alive": rep.alive(), "restarts": rep.restarts,
                    "dispatched": rep.dispatched, "breakers": states,
                })
            terminal = [dict(row) for row in self._terminal.values()]
            recent = [t for t in self._recent_fail if now - t <= window_s]
            phase = self._phase
            restore_result = dict(self._restore_result) if self._restore_result else None
            seen_labels = sorted(self._seen_labels)
            scored = [(rep.name, rep.score) for rep in self._replicas
                      if rep.score is not None]
            lane_devices = list(dict.fromkeys(rep.device for rep in self._replicas))
            tenant_depths: Optional[Dict[str, int]] = None
            if self._admission is not None:
                # merge the lanes' per-tenant depth maps (no request scan)
                tenant_depths = {}
                for rep in self._replicas:
                    for t, dq in rep.q.depths().items():
                        tenant_depths[t] = tenant_depths.get(t, 0) + dq
        for row in terminal:
            lanes.append({"queue_depth": 0, "inflight": 0, "oldest_queued_s": 0.0,
                          "worker_alive": False, "breakers": {}, **row})
        restore_stuck_s = None
        if phase == PHASE_RESTORING and self._restore_started is not None:
            age = now - self._restore_started
            if age > self.restore_stuck_after_s:
                restore_stuck_s = round(age, 3)
        integrity = None
        if self._integrity is not None:
            # scores are self-locked leaves: read outside _cond
            scores = {name: sc.snapshot(now) for name, sc in scored}
            integrity = {
                "policy": self._integrity.describe(), "abft": self._integrity.abft,
                "replicas": scores,
                "quarantined": sorted(n for n, v in scores.items()
                                      if v["state"] == _integ.SCORE_QUARANTINED),
            }
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
        trace_ring = spans.pressure() if spans.is_on() else None
        cost = devices = None
        if devmon.is_on():
            cost = self.cache.costs_by_label() or None
            for lbl, ent in latency.items():
                per = (cost or {}).get(lbl)
                if per:
                    pk = max((c.get("peak_bytes") or 0) for c in per.values())
                    if pk:
                        ent["peak_bytes"] = int(pk)
            devices = devmon.sample_devices(lane_devices)
        adm = self._admission
        return {
            "ok": running and alive,
            "phase": phase,
            "ready": bool(running and alive and phase == PHASE_READY),
            "restore": restore_result,
            "restore_stuck_s": restore_stuck_s,
            "integrity": integrity,
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
            "trace_ring": trace_ring,
            "cost": cost,
            "devices": devices,
            "factor_cache": (self.factor_cache.stats()
                             if self.factor_cache is not None else None),
            # the device factor arena (None when unarmed): per-lane
            # residency and the byte ledger against its budget
            "arena": self.arena.stats() if self.arena is not None else None,
            "tenants": (adm.tenants_health(tenant_depths, now=now)
                        if adm is not None else None),
            "admission": adm.snapshot() if adm is not None else None,
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
            sync.guarded(rep, "inflight")
            inflight, rep.inflight = rep.inflight, []
            rep.restarts += 1
            self._restarts += 1
            running = self._running
            # a draining lane is never respawned; its retried work is
            # re-homed by remove_replica's final sweep
            respawn = running and not rep.stopping
        self._note_failure()
        for r in inflight:
            if r.future.done():
                continue
            if running and r.retries > 0:
                self._requeue_with_backoff(rep, r)
            else:
                _resolve_exc(r.future, SlateError(f"worker died mid-batch: {exc!r}"),
                             req=r)
        if respawn:
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
                sync.guarded(rep, "inflight")
                rep.inflight = batch
            faults.check("worker_death")  # in flight: supervision must cover
            self._execute(rep, batch)
            with self._cond:
                sync.guarded(rep, "inflight")
                rep.inflight = []

    def _pop_eligible_locked(self, rep: _Replica, now: float) -> Optional[_Request]:
        """Oldest request whose retry backoff has elapsed -- or, admission
        plane on, the weighted-fair choice across tenants (FIFO within a
        tenant, exactly FIFO with one)."""
        sync.guarded(rep, "q")
        if self._admission is not None:
            return rep.q.pop_eligible(now)
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
            while self._running and not rep.stopping:
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
                if (self._integrity is not None and self._integrity.hedge_factor > 0
                        and len(self._replicas) > 1 and metrics.is_on()):
                    # deadline-risk stragglers of every lane (a wedged
                    # lane cannot sweep its own queue) get a duplicate on
                    # another lane
                    self._hedge_stragglers_locked(now)
                first = self._pop_eligible_locked(rep, now)
                if first is not None:
                    break
                if rep.q:  # everything is backing off: sleep to the next
                    wake = min(r.not_before for r in rep.q) - now
                    self._cond.wait(min(max(wake, 0.001), 0.05))
                else:
                    self._cond.wait(0.05)
            if rep.stopping and self._running:
                # a lane leaving a running service: stragglers (a
                # supervisor requeue, a hedge clone) re-home to survivors
                self._rehome_queue_locked(rep)
                return None
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

        # the coalesce window: static, or (admission plane on) the
        # bucket's AIMD window times the overload shrink factor
        win = (self.batch_window_s if self._admission is None
               else self._admission.window_for(first.key.label))
        if self.batch_max > 1 and win > 0:
            with self._cond:
                now = time.monotonic()
                if not any(company(r, now) for r in rep.q):
                    self._cond.wait(win)
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
        """Deadline passed while still queued: cancel, never start.  A
        hedge twin (or a primary whose twin delivered) only resolves its
        member: the logical request is accounted once, by its primary."""
        if req.is_hedge or req.future.done():
            _resolve_exc(req.future, DeadlineExceeded(f"{req.routine}: hedge twin expired"),
                         req=req)
            return
        metrics.inc("serve.deadline_miss")
        metrics.inc("serve.deadline_miss_queued")
        if self._admission is not None:
            # a queued cancel is an SLO exhaustion: the overload controller
            # sees its actual overrun (deliveries are not the only signal)
            now = time.monotonic()
            self._admission.observe_finish(
                self._lat_label(req), req.tenant, req.priority, now - req.t_submit,
                req.deadline - req.t_submit if req.deadline is not None else None,
                now, trace=req.trace, windowed=req.key is not None)
        _resolve_exc(req.future, DeadlineExceeded(
            f"{req.routine} {req.m}x{req.n}: deadline passed after "
            f"{time.monotonic() - req.t_submit:.3f}s in queue"), req=req)

    @staticmethod
    def _miss_late(req: Optional[_Request] = None) -> None:
        """Finished past the deadline: result still delivered, counted —
        once a logical request (never for a hedge twin, nor for a hedged
        primary whose twin already delivered)."""
        if req is not None and (req.is_hedge
                                or (req.hedge_group is not None and req.future.done())):
            return
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
            sync.guarded(rep, "q")
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
                # deterministic, never retried (negative info is the ABFT
                # bad flag, read by the certification below)
                if late:
                    self._miss_late(r)
                self._observe_total(rep, key.label, r, now)
                metrics.inc("serve.numerical_errors")
                deliver.append(functools.partial(
                    _resolve_exc, r.future, NumericalError(f"{r.routine}: info={info}", info), r))
                continue
            abft_bad = info < 0
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
            # delivery certification (one branch when the plane is off):
            # a finite wrong X (sdc_solve / sdc_factor, a flaky device)
            # never reaches the client.  ABFT buckets carry the on-device
            # verdict for free; the host certificate covers the
            # device-to-host leg.  A failed certificate re-executes.
            if self._integrity is not None and r.routine in ("gesv", "posv"):
                if not self._certify(rep, r, X, key, abft_bad):
                    deliver.append(functools.partial(self._cert_reexecute, rep, r))
                    continue
            elif abft_bad:
                # a flagged X from a checksummed core is never delivered
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
        ar = self.arena
        if ar is None:
            # factor_stale: a finite wrong factor, perturbed on its own
            # device; only the residual check below can catch it
            F = faults.perturb("factor_stale", entry.factor)
        else:
            F = self._arena_factor(ar, rep, entry)
        if devmon.is_on():
            # the lane device's memory gauges at each hit dispatch
            devmon.sample_devices([rep.device])
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
            if ar is not None:
                # the device copies go with the host entry: a stale
                # factor must not keep serving from residency
                ar.drop(entry.fp)
        if len(batch) > 1:
            metrics.inc("serve.batched")
            metrics.inc("serve.batched_requests", len(batch))
        return deliver, corrupt

    @staticmethod
    def _arena_factor(ar, rep: _Replica, entry: FactorEntry):
        """The armed hit's factor operand on the lane's device: the
        resident buffer (``hit``, or ``cross_replica`` from a peer lane),
        else one upload of the pinned host factor, installed for the
        hits to come (``put``; with the device monitor on, the arena
        then checks the device's memory pressure).  Chaos bypasses the
        arena: the ``factor_stale`` perturbation must reach the operand
        dispatched, and a perturbed factor is never made resident."""
        if faults.is_on():
            return faults.perturb("factor_stale", entry.factor)
        F = ar.get(entry.fp, rep.lane, device=rep.device)
        if F is None:
            F = ar.put(entry.fp, rep.lane, entry.factor, device=rep.device)
            if devmon.is_on():
                ar.pressure(rep.lane, rep.device)
        return F

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
                    armed = self.arena is not None
                    if entry is not None:
                        # an armed entry's factor is on the host: solve on
                        # the lane's device
                        X = solve_from_factor(entry, req.B,
                                              device=rep.device if armed else None)
                        if residual_ok(req.A, req.B, X, routine=req.routine):
                            _fc_record("hit", fp=fp, label=entry.key.label)
                            spans.annotate(factor_hit=True)
                        else:
                            _fc_record("stale", fp=fp, label=entry.key.label)
                            fc.invalidate(fp)
                            if armed:
                                self.arena.drop(fp)
                            entry, X = None, None
                    if entry is None:
                        # sdc_factor: a silently wrong fresh factor; this
                        # request's X goes wrong (certification catches it)
                        # and the poisoned entry is cached (later hits fall
                        # to the residual fence)
                        if req.routine == "gels":
                            factor = gels_factor_pack(req.A, fkey, schedule=self.schedule,
                                                      device=rep.device)
                            factor = faults.perturb("sdc_factor", factor)
                            perm = None
                        else:
                            raw, perm = factor_only(req.routine, req.A,
                                                    schedule=self.schedule,
                                                    device=rep.device)
                            raw = faults.perturb("sdc_factor", raw)
                            factor = pad_square_t(raw, fkey.n)
                        entry = FactorEntry(fp=fp, routine=req.routine, key=fkey,
                                            factor=factor, perm=perm, n=req.n)
                        if fc is not None and fp:
                            # armed: the cache keeps a pinned host copy and
                            # this device factor is freed after the solve
                            fc.put(host_entry(entry) if armed else entry,
                                   replica=rep.name)
                            # the hits to come ride the warmed manifest
                            self.cache.ensure_manifest(entry.solve_key, (1, self.batch_max))
                        X = solve_from_factor(entry, req.B)
                spans.annotate(outcome="ok")
        except Exception as e:  # noqa: BLE001 — futures carry the error
            _resolve_exc(req.future, e, req=req)
            return
        # delivery certification: the factor path is where sdc_factor
        # bites (a finite wrong X no finiteness fence sees)
        if self._integrity is not None and not self._certify(rep, req, X, req.key, False):
            self._cert_reexecute(rep, req)
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
        per-lane histograms, plus the deadline-budget burn tiers, and,
        admission plane on, the control loop (per-tenant burn, the
        overload EWMA, the bucket's AIMD window), which runs with metrics
        on or off.  One total a logical request: hedge twins, and a hedged
        primary whose twin already delivered, are skipped."""
        if req.is_hedge or (req.hedge_group is not None and req.future.done()):
            return
        total = now - req.t_submit
        if metrics.is_on():
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
        if self._admission is not None:
            self._admission.observe_finish(
                label, req.tenant, req.priority, total,
                req.deadline - req.t_submit if req.deadline is not None else None,
                now, trace=req.trace, lane=rep.lane if rep is not None else None,
                windowed=req.key is not None)

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
        # the direct path is hardware like any other: sdc_solve fires
        # here too, and the re-execution fallback re-certifies
        if (self._integrity is not None and req.routine in ("gesv", "posv")
                and not self._certify(None, req, X, req.key, False)):
            self._cert_reexecute(None, req)
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

    # -- integrity: certification, quarantine, hedged re-execution ---------

    def _certify(self, rep: Optional[_Replica], req: _Request, X: np.ndarray,
                 key: Optional[_bk.BucketKey], abft_bad: bool) -> bool:
        """One delivery's certificate (the plane is on); True to deliver,
        False to re-execute.  The verdict: the on-device ABFT flag, then,
        by the policy's gate (always for a re-execution and for a
        quarantined lane), the host check — the checksum relation for
        ABFT buckets, the residual fence otherwise.  Every verdict feeds
        the lane's score; the transitions are counted per lane."""
        integ = self._integrity
        if abft_bad:
            ok = False
        elif (req.cert_fails or (rep is not None and rep.score is not None
                                 and rep.score.suspect())
              or integ.should_check()):
            A = _cert_operand(req)
            ok = (_abft.checksum_certificate(A, req.B, X)
                  if key is not None and key.tag == _abft.ABFT_TAG
                  else residual_ok(A, req.B, X, routine=req.routine))
        else:
            return True  # an unsampled delivery: no verdict, no score move
        metrics.inc("serve.integrity.checked")
        if rep is not None and rep.score is not None:
            ev = rep.score.observe(ok, time.monotonic())
            if ev == "quarantined":
                metrics.inc("serve.integrity.quarantined")
                metrics.inc(rep.quar_counter)
                spans.event("quarantined", trace=req.trace, lane=rep.lane, replica=rep.name)
            elif ev == "recovered":
                metrics.inc("serve.integrity.unquarantined")
                metrics.inc(rep.unquar_counter)
                spans.event("unquarantined", trace=req.trace, lane=rep.lane,
                            replica=rep.name)
        if ok:
            if req.cert_fails:
                # a previously failed request delivered a passing result
                metrics.inc("serve.integrity.recovered")
                if req.reexec_hedged:
                    metrics.inc("serve.hedge.won")
                    req.reexec_hedged = False
            return True
        metrics.inc("serve.integrity.fail")
        self._note_failure()
        if req.trace is not None:
            spans.event("cert_fail", trace=req.trace,
                        lane=rep.lane if rep is not None else "direct",
                        bucket=key.label if key is not None else None, abft=abft_bad)
        return False

    def _cert_reexecute(self, rep: Optional[_Replica], req: _Request) -> None:
        """A failed certificate never reaches the client.  While the
        policy's retry budget lasts the request is hedged to another lane
        (``serve.hedge.sent``), or with no other lane re-runs on the
        direct driver (which re-certifies).  Past the budget: one
        last-resort direct solve behind the residual fence, delivered
        only when it passes, else a typed NumericalError
        (``serve.integrity.abandoned``)."""
        integ = self._integrity
        req.cert_fails += 1
        if req.future.done():
            # a hedge twin already delivered: nothing to re-execute for
            _resolve_exc(req.future, NumericalError(
                f"{req.routine}: certificate-failed result discarded; hedge twin "
                "already delivered"), req=req)
            return
        if req.is_hedge:
            # a straggler clone is never re-executed: its primary keeps
            # the ladder
            _resolve_exc(req.future, NumericalError(
                f"{req.routine}: hedge result failed certification"), req=req)
            return
        if req.cert_fails <= integ.cert_retry_max:
            other = None
            if len(self._replicas) > 1:
                excluded = self._quarantined_names()
                with self._cond:
                    if not (self._stopped or not self._running):
                        other = self._least_loaded_other_locked(rep, excluded)
                    if other is not None:
                        metrics.inc("serve.hedge.sent")
                        req.reexec_hedged = True
                        req.not_before = 0.0
                        # the queued histogram observed it at its first
                        # dispatch; the re-enqueue must not observe it twice
                        req.attempt = max(req.attempt, 1)
                        if req.span is not None and spans.is_on():
                            req.qspan = spans.start("queued", trace=req.trace,
                                                    parent=req.span, lane=other.lane,
                                                    hedge=True)
                        sync.guarded(other, "q")
                        other.q.appendleft(req)
                        self._gauge_queues_locked()
                        self._cond.notify_all()
            if other is not None:
                if req.trace is not None:
                    spans.event("hedge", trace=req.trace, lane=other.lane,
                                reason="certificate", attempt=req.cert_fails)
                return
            # one lane: the direct driver is the path off the suspect
            # executable; _direct re-certifies
            self._direct(req)
            return
        try:
            with metrics.phase(f"serve.direct.{req.routine}"):
                X = direct_call(req.routine, req.A, req.B, device=self._replicas[0].device)
        except Exception as e:  # noqa: BLE001 — futures carry the error
            _resolve_exc(req.future, e, req=req)
            return
        if residual_ok(_cert_operand(req), req.B, X, routine=req.routine):
            metrics.inc("serve.integrity.recovered")
            if req.reexec_hedged:
                metrics.inc("serve.hedge.won")
                req.reexec_hedged = False
            now = time.monotonic()
            if req.deadline is not None and now > req.deadline:
                self._miss_late(req)
            self._observe_total(rep, self._lat_label(req), req, now)
            _resolve(req.future, X, req)
            return
        # the last-resort fence caught corruption too: a detection
        # beside the refusal
        metrics.inc("serve.integrity.fail")
        metrics.inc("serve.integrity.abandoned")
        _resolve_exc(req.future, NumericalError(
            f"{req.routine}: result failed integrity certification {req.cert_fails}x "
            "across re-executions; refusing to deliver an uncertified X"), req=req)

    def _quarantined_names(self) -> set:
        """Lanes quarantine-excluded now (scores are self-locked leaves)."""
        now = time.monotonic()
        return {r.name for r in self._replicas
                if r.score is not None and r.score.excluded(now)}

    def _least_loaded_other_locked(self, rep: Optional[_Replica],
                                   excluded: set) -> Optional[_Replica]:
        """The least-loaded lane other than ``rep``, preferring lanes not
        in ``excluded`` and falling back to one that is: the hedge target
        of the certificate re-execution and the straggler sweep."""
        best = best_ex = None
        load_b = load_ex = 0
        for r in self._replicas:
            if r is rep:
                continue
            load = len(r.q) + len(r.inflight)
            if r.name in excluded:
                if best_ex is None or load < load_ex:
                    best_ex, load_ex = r, load
            elif best is None or load < load_b:
                best, load_b = r, load
        return best if best is not None else best_ex

    def _hedge_stragglers_locked(self, now: float) -> None:
        """Any queued request older than ``hedge_factor`` x its bucket's
        p99 total latency gets a duplicate on the least-loaded healthy
        other lane; the first correct result wins the shared Future.
        Rate-limited to one sweep a ``hedge_min_age_s`` across the
        service.  Caller holds ``_cond``; the plane is on, there are two
        lanes or more and metrics are on (the p99 source)."""
        integ = self._integrity
        if now - self._hedge_last_sweep < max(integ.hedge_min_age_s, 0.01):
            return
        self._hedge_last_sweep = now
        excluded: Optional[set] = None
        p99s: dict = {}
        hedged = False
        for rep in self._replicas:
            for r in list(rep.q):
                if (r.is_hedge or r.hedge_group is not None or r.key is None
                        or r.attempt or r.cert_fails):
                    continue
                age = now - r.t_submit
                if age < integ.hedge_min_age_s:
                    continue
                lbl = r.key.label
                if lbl not in p99s:
                    p99s[lbl] = metrics.percentile(f"serve.latency.{lbl}.total", 99)
                p99 = p99s[lbl]
                if p99 is None or age < integ.hedge_factor * p99:
                    continue
                if excluded is None:
                    excluded = self._quarantined_names()
                tgt = self._least_loaded_other_locked(rep, excluded)
                if tgt is None:
                    continue
                grp = _HedgeGroup()
                r.hedge_group = grp
                clone = _Request(routine=r.routine, key=r.key, A=r.A, B=r.B, m=r.m, n=r.n,
                                 nrhs=r.nrhs, future=r.future, deadline=r.deadline,
                                 retries=0, tenant=r.tenant, priority=r.priority,
                                 tenanted=r.tenanted, factor_fp=r.factor_fp,
                                 factor_miss=r.factor_miss, is_hedge=True, hedge_group=grp)
                # attempt=1: no second queued observation; the twin keeps
                # the primary's clock
                clone.attempt = 1
                clone.t_submit = r.t_submit
                metrics.inc("serve.hedge.sent")
                if r.trace is not None:
                    spans.event("hedge", trace=r.trace, lane=tgt.lane, reason="straggler",
                                age_s=round(age, 4))
                sync.guarded(tgt, "q")
                tgt.q.appendleft(clone)
                hedged = True
        if hedged:
            # wake the targets only when something was enqueued
            self._cond.notify_all()


def _cert_operand(req: _Request) -> np.ndarray:
    """The operand a certificate checks against: gesv reads all of A,
    posv only its lower triangle (symmetrized here, as ``posv_check``
    does on the device)."""
    if req.routine != "posv":
        return req.A
    A = np.asarray(req.A)
    return np.tril(A) + np.conj(np.tril(A, -1)).T


# -- CUDA linear algebra, loaded once ---------------------------------------

_linalg_lock = sync.Lock(name="service._linalg_lock")
_linalg_loaded = False


def _load_cuda_linalg(devices) -> None:
    """torch loads its CUDA linear-algebra library at the first linalg
    call on a CUDA device, and that loader is not thread-safe: two lanes
    making their first call at once fail with "lazy wrapper should be
    called at most once".  Make that call here, once a process, before a
    lane's worker starts.  No-op without a CUDA lane."""
    global _linalg_loaded
    dev = next((d for d in devices if d.type == "cuda"), None)
    if dev is None or _linalg_loaded:
        return
    with _linalg_lock:
        if not _linalg_loaded:
            torch.linalg.cholesky_ex(torch.ones(1, 1, device=dev))
            _linalg_loaded = True


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
    # the worker's writes to the result happen-before any thread that
    # reads it off the future (one bool when the race plane is off)
    sync.hb_publish(fut)
    g = req.hedge_group if req is not None else None
    if g is not None:
        # the first correct result wins the shared future; the loser's
        # work is the hedge's cost
        if g.first_result():
            if not fut.done():
                fut.set_result(value)
            if req.is_hedge:
                metrics.inc("serve.hedge.won")
        else:
            metrics.inc("serve.hedge.wasted")
        return
    if not fut.done():
        fut.set_result(value)


def _resolve_exc(fut: Future, exc: Exception, req: Optional[_Request] = None) -> None:
    _finish_spans(req, type(exc).__name__)
    if _delivery_taps and req is not None:
        _fire_delivery_taps(req, type(exc).__name__)
    sync.hb_publish(fut)  # hand-off edge, as in _resolve
    if req is not None and isinstance(exc, SlateError):
        # tenant identity only where tenancy is real: the plane-off error
        # strings stay as they were
        exc.with_context(routine=req.routine,
                         bucket=req.key.label if req.key is not None else None,
                         attempt=req.attempt,
                         tenant=req.tenant if req.tenanted else None,
                         priority=_bk.priority_name(req.priority) if req.tenanted else None)
    g = req.hedge_group if req is not None else None
    if g is not None:
        # a hedged pair fails only as a whole
        if g.member_failed() and not fut.done():
            fut.set_exception(exc)
        return
    if not fut.done():
        fut.set_exception(exc)
