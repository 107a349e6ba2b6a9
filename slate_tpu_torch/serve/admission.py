"""Overload-resilient admission control: tenant fairness, priority
shedding, and a self-tuning batch window.

The serving tier was SLO-*measured* (per-bucket latency histograms,
``slo_burn`` tiers, ``oldest_queued_s``) but not SLO-*defended*: queue
limit and batch window were static configuration and every request was
anonymous — one bursty client could fill the bounded queue and starve
everyone else.  This module is the control plane that closes the loop
(Clipper NSDI'17 for the adaptive batching shape, Dapper-style
per-request context for the tenant/priority plumbing -- PAPERS.md):

* **Tenants** — ``submit(tenant=...)`` tags every request; a spec
  (:data:`TENANTS_ENV` / ``Option.ServeTenantQuota`` /
  ``SolverService(tenants=...)``) gives each tenant a weighted-fair
  share, a token-bucket quota, and a queue-share cap, so a hot tenant
  sheds ITS OWN load first (``Rejected`` becomes per-tenant) instead
  of filling the shared FIFO.
* **Weighted-fair queues** (:class:`FairQueue`) — each serving lane's
  FIFO becomes a per-tenant virtual-time scheduler: the next dispatch
  goes to the eligible tenant with the smallest virtual finish time,
  advanced by ``1/weight`` per pop, so an N-request backlog from one
  tenant no longer head-of-line-blocks everyone else.  FIFO order is
  preserved within a tenant, and with a single tenant the schedule
  degenerates to exactly the old FIFO.
* **Priority shedding** (:class:`OverloadController`) — three priority
  classes (``buckets.PRIORITIES``); when the EWMA of the delivered
  deadline-budget burn crosses a tier, admission sheds
  lowest-priority-first with a typed ``Shed`` error (distinct from
  ``Rejected``: the service is overloaded, not full — back off and
  retry later).  Escalation is immediate, de-escalation waits out a
  dwell (breaker-style hysteresis, so the controller never flaps), and
  while shedding the coalesce window is shrunk (batching latency is
  the one knob admission owns mid-flight).
* **Adaptive batch window** (:class:`AdaptiveWindow`) — per bucket, an
  AIMD controller picks the coalesce window from observed delivered
  latency vs. the p99 budget (Clipper's additive-increase /
  multiplicative-decrease shape): under budget the window widens
  additively toward ``Option.ServeBatchWindow`` (the ceiling — more
  coalescing, better throughput), over budget it halves (less waiting,
  lower tail), and in the hysteresis band between it holds.  Every
  decision is recorded (``serve.adaptive.<bucket>.window_s`` gauge,
  ``.widen``/``.shrink`` counters, an ``adaptive_window`` span
  instant) so ``tools/latency_report.py`` can show the trajectory.

**Zero overhead off**: with no tenant spec and adaptation off,
``AdmissionControl.from_options`` returns None and the service pays one
``is None`` branch per submit — queues stay plain deques, no metric is
emitted, behavior is byte-identical to the pre-admission tier.

Per-tenant metric families (``serve.tenant.<id>.*``,
``serve.latency.tenant.<id>.total``) are cardinality-capped at
:data:`TENANT_METRIC_CAP` distinct ids (``metrics.CappedKeys``, the
factor-cache fingerprint pattern), the control plane's own per-tenant
state at :data:`TENANT_STATE_CAP` (oldest unconfigured id evicted),
and FairQueue's virtual-time maps are pruned to the queue's current
tenant set — so a churning tenant-id stream cannot leak registry keys
OR process memory forever.

Spec grammar (:data:`TENANTS_ENV` / ``Option.ServeTenantQuota``)::

    spec        := tenant_spec (';' tenant_spec)*
    tenant_spec := name ':' item (',' item)*
    item        := 'weight=<float>'   # WFQ weight (default 1)
                 | 'rate=<float>'     # token-bucket refill, req/s
                                      # (default 0 = unlimited)
                 | 'burst=<int>'      # bucket capacity (default
                                      # max(1, ceil(rate)); requires
                                      # rate= — no refill, no quota)
                 | 'share=<float>'    # max fraction of the queue this
                                      # tenant may occupy (default 1.0)

The entry named ``default`` configures the anonymous pool AND is the
template for tenants the spec does not name.  Example::

    SLATE_TPU_TENANTS="gold:weight=4;free:weight=1,rate=20,share=0.25" \\
    SLATE_TPU_ADAPTIVE=0.25 python app.py   # adaptive on, p99 budget 250 ms
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..aux import metrics, spans, sync
from .buckets import (
    DEFAULT_TENANT,
    PRIORITIES,
    PRIO_NORMAL,
    check_priority,
)

TENANTS_ENV = "SLATE_TPU_TENANTS"
ADAPTIVE_ENV = "SLATE_TPU_ADAPTIVE"


def resolve_identity(tenant, priority) -> Tuple[str, int]:
    """Normalize a submit-time (tenant, priority) pair — the ONE
    normalizer, used by the plane-on path (AdmissionControl.resolve)
    AND the plane-off path in service.submit, so enabling tenancy
    never changes which tags a client may pass (a tenant id the plane
    would reject must fail identically with the plane off)."""
    t = DEFAULT_TENANT if tenant is None else str(tenant)
    if not t:
        raise ValueError("tenant id must be a non-empty string")
    p = PRIO_NORMAL if priority is None else check_priority(priority)
    return t, p

#: cardinality cap on the per-tenant metric families (counters AND the
#: per-tenant latency histograms): tenant ids are caller-controlled
#: strings, so without the cap a churning id stream leaks one registry
#: key per id forever.  Past the cap, events still count globally and
#: in the health snapshot; ``serve.tenant_overflow`` counts the spill.
TENANT_METRIC_CAP = 64

#: cap on the control plane's own per-tenant state (_TenantState:
#: counters + token bucket) — the in-memory twin of the metric cap.
#: Past it, the oldest UNCONFIGURED tenant's state is evicted (its
#: counters reset, its bucket refills on return); spec-named tenants
#: are never evicted, their count is operator-bounded.
TENANT_STATE_CAP = 256


# ---------------------------------------------------------------------------
# tenant configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TenantConfig:
    """One tenant's admission contract (see the module grammar)."""

    name: str
    weight: float = 1.0
    rate: float = 0.0  # token-bucket refill, req/s; 0 = unlimited
    burst: int = 0  # bucket capacity; 0 = max(1, ceil(rate))
    share: float = 1.0  # max fraction of max_queue this tenant occupies

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        if self.rate < 0:
            raise ValueError(f"tenant {self.name!r}: rate must be >= 0")
        if self.burst < 0:
            raise ValueError(f"tenant {self.name!r}: burst must be >= 0")
        if self.burst > 0 and self.rate <= 0:
            # a bucket with capacity but no refill would either be
            # inert (what a silent pass produces) or a lifetime cap
            # (never what an operator means by "burst") — refuse to
            # start rather than ignore a quota the operator believes
            # is active
            raise ValueError(
                f"tenant {self.name!r}: burst= requires rate= "
                "(a token bucket with no refill is not a quota)"
            )
        if not 0 < self.share <= 1:
            raise ValueError(
                f"tenant {self.name!r}: share must be in (0, 1]"
            )

    @property
    def capacity(self) -> int:
        """Token-bucket capacity (0 when the quota is unlimited —
        rate == 0; validation refuses burst without rate)."""
        if self.rate <= 0:
            return 0
        return self.burst if self.burst > 0 else max(1, math.ceil(self.rate))


def parse_tenants(spec: str) -> Dict[str, TenantConfig]:
    """Parse the :data:`TENANTS_ENV` grammar into per-tenant configs."""
    out: Dict[str, TenantConfig] = {}
    for part in str(spec).split(";"):
        part = part.strip()
        if not part:
            continue
        name, sep, items = part.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"tenant spec {part!r}: empty tenant name")
        kw: dict = {}
        if sep:
            for item in items.split(","):
                item = item.strip()
                if not item:
                    continue
                k, isep, v = item.partition("=")
                k, v = k.strip(), v.strip()
                if not isep:
                    raise ValueError(
                        f"tenant spec item {item!r} in {part!r}"
                    )
                if k in ("weight", "rate", "share"):
                    kw[k] = float(v)
                elif k == "burst":
                    kw[k] = int(v)
                else:
                    raise ValueError(
                        f"unknown tenant spec key {k!r} in {part!r}"
                    )
        out[name] = TenantConfig(name=name, **kw)
    return out


class TokenBucket:
    """Deterministic token bucket: ``capacity`` tokens, refilled at
    ``rate``/s from the timestamps the caller passes in (no internal
    clock — the quota-refill unit tests drive it with a fake one)."""

    __slots__ = ("rate", "capacity", "tokens", "t_last")

    def __init__(self, rate: float, capacity: int, now: float = 0.0):
        self.rate = float(rate)
        self.capacity = float(capacity)
        # refill state is mutated by take()/remaining(), always called
        # under the admission plane's lock
        self.tokens = float(capacity)  # guarded by: _lock (external)
        self.t_last = float(now)  # guarded by: _lock (external)

    def _refill(self, now: float) -> None:
        dt = now - self.t_last
        if dt <= 0:
            # never rewind the clock: a read with an older timestamp
            # (health() snapshots `now` before doing other work) must
            # not reset t_last backwards, or the next take() would
            # re-credit the already-consumed interval and admit a
            # rate-limited tenant above its configured rate
            return
        self.t_last = now
        self.tokens = min(self.capacity, self.tokens + dt * self.rate)

    def take(self, now: float) -> bool:
        """Consume one token (True) or report the bucket dry (False)."""
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def remaining(self, now: float) -> float:
        self._refill(now)
        return self.tokens


# ---------------------------------------------------------------------------
# weighted-fair lane queue
# ---------------------------------------------------------------------------


class FairQueue:
    """Per-tenant weighted-fair queue for one serving lane — the
    replacement for the lane's plain FIFO deque when tenancy is on.

    Virtual-time WFQ (stride-scheduling flavor): each tenant carries a
    virtual time advanced by ``1/weight`` per popped request;
    :meth:`pop_eligible` serves the eligible tenant with the smallest
    virtual time (ties broken oldest-first), so over any backlog window
    tenants drain in weight proportion and one tenant's burst cannot
    head-of-line-block the rest.  A tenant going idle and returning is
    clamped to the current virtual now (it gets its share, not a
    catch-up monopoly).  FIFO order within a tenant is preserved, and
    with a single tenant the schedule IS the old FIFO.

    Deque-compatible surface (``append``/``appendleft``/``remove``/
    ``clear``/``__len__``/``__iter__`` in arrival order) so the
    service's sweep/coalesce/drain code runs unchanged on either queue
    kind.  NOT internally locked: every access happens under the
    service's condition lock, like the deques it replaces.
    """

    __slots__ = ("_adm", "_items", "_vtime", "_vnow", "_depth")

    def __init__(self, adm: "AdmissionControl"):
        self._adm = adm
        # externally synchronized (see class docstring): every access
        # happens under the owning service's condition lock, like the
        # deque this queue replaces — the lint annotations document
        # that contract and police any access from OUTSIDE this class
        self._items: List = []  # guarded by: _cond (external) — arrival order
        self._vtime: Dict[str, float] = {}  # guarded by: _cond (external)
        self._vnow = 0.0  # guarded by: _cond (external)
        self._depth: Dict[str, int] = {}  # guarded by: _cond (external)

    # -- deque-compatible surface ------------------------------------------

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def _arrive(self, r) -> None:
        t = r.tenant
        if not self._depth.get(t):
            # idle tenant returning: clamp its virtual time forward so
            # a long-idle tenant cannot monopolize the lane to "catch
            # up" — it resumes at the current virtual now
            self._vtime[t] = max(self._vtime.get(t, 0.0), self._vnow)
        self._depth[t] = self._depth.get(t, 0) + 1

    def append(self, r) -> None:
        self._arrive(r)
        self._items.append(r)

    def appendleft(self, r) -> None:
        """Retry re-enqueue: the request goes back to its tenant's head
        (and, tenant-fairness aside, to the front of arrival order —
        the deque semantics the retry path was built on)."""
        self._arrive(r)
        self._items.insert(0, r)

    def remove(self, r) -> None:
        self._items.remove(r)
        t = r.tenant
        d = self._depth.get(t, 0) - 1
        if d > 0:
            self._depth[t] = d
        else:
            self._depth.pop(t, None)
            # bounded state: an idle tenant's virtual time is dropped —
            # the arrival clamp resumes it at the virtual now, so the
            # maps never outgrow the queue's CURRENT tenant set (a
            # churning caller-controlled id stream cannot leak one
            # float per id forever)
            self._vtime.pop(t, None)

    def clear(self) -> None:
        self._items.clear()
        self._depth.clear()
        self._vtime.clear()

    def depth(self, tenant: str) -> int:
        """Queued requests of one tenant in THIS lane."""
        return self._depth.get(tenant, 0)

    def depths(self) -> Dict[str, int]:
        """Per-tenant queued counts of THIS lane (a copy) — health()
        merges the lanes' maps instead of re-scanning every request."""
        return dict(self._depth)

    # -- the scheduler ------------------------------------------------------

    def pop_eligible(self, now: float):
        """The weighted-fair replacement for "oldest eligible request":
        among requests whose retry backoff has elapsed, serve the
        tenant with the smallest virtual time; None when nothing is
        eligible."""
        heads: Dict[str, object] = {}
        want = len(self._depth)  # tenants currently queued
        for r in self._items:
            if r.not_before <= now and r.tenant not in heads:
                heads[r.tenant] = r
                if len(heads) == want:
                    break  # every queued tenant has its head: the
                    # common single-tenant case stays near-O(1)
        if not heads:
            return None
        t = min(
            heads,
            key=lambda k: (self._vtime.get(k, 0.0), heads[k].t_submit),
        )
        r = heads[t]
        v = self._vtime.get(t, 0.0)  # before remove() may prune it
        self.remove(r)
        f = v + 1.0 / self._adm.config_for(t).weight  # finish tag
        # monotone virtual now, advanced to the served request's FINISH
        # tag: (a) a request popped late off a stale small vtime (retry
        # backoff) cannot drag vnow backwards and hand the next arrival
        # a catch-up monopoly; (b) the charge survives a pruned map
        # entry — a closed-loop tenant whose queue empties on every pop
        # re-enters AT its own finish tag via the arrival clamp, so it
        # drains in weight proportion instead of re-arriving in the
        # past and starving the backlogged tenants behind it
        self._vnow = max(self._vnow, f)
        if self._depth.get(t):
            self._vtime[t] = f
        return r


# ---------------------------------------------------------------------------
# adaptive batch window (AIMD, Clipper-shaped)
# ---------------------------------------------------------------------------


class AdaptiveWindow:
    """Per-bucket AIMD controller for the coalesce window.

    Decisions fire every ``decide_every`` finished observations over
    the worst (max) BURN RATIO — each request's total latency divided
    by ITS OWN budget — seen in that decision window (the small-sample
    p99 proxy).  Ratio, not raw latency: a bucket serving mixed
    deadlines (a 2 s solve inside a 5 s budget next to a 40 ms solve
    inside a 50 ms budget) must judge each against its own contract,
    or one tenant's generous deadline would misread as another's SLO
    melt.  Worst ratio > 1: multiplicative decrease (``window *=
    beta``, less lingering, lower tail).  Worst ratio <= 0.5: additive
    increase (``window += step`` up to the ceiling, more coalescing).
    Between the two — the hysteresis band — hold, so a latency sitting
    near budget never makes the window flap.  Budget-less observations
    ride the count but carry no ratio; a window with none is a no-op.
    Observation-count (not wall-clock) driven: a fake-clock-free pure
    function of the finished-latency sequence, which is what the
    convergence unit tests replay."""

    __slots__ = (
        "ceiling_s", "floor_s", "step_s", "beta", "decide_every",
        "window_s", "widens", "shrinks", "_worst", "_count", "_budgeted",
    )

    def __init__(
        self,
        ceiling_s: float,
        floor_s: float = 0.0,
        step_s: Optional[float] = None,
        beta: float = 0.5,
        decide_every: int = 8,
    ):
        self.ceiling_s = float(ceiling_s)
        self.floor_s = float(floor_s)
        self.step_s = (
            float(step_s) if step_s is not None
            else max(self.ceiling_s / 8.0, 1e-5)
        )
        self.beta = float(beta)
        self.decide_every = int(decide_every)
        # start at the ceiling: with no latency pressure the adaptive
        # service batches exactly like the static one
        self.window_s = self.ceiling_s
        self.widens = 0
        self.shrinks = 0
        self._worst = 0.0  # worst burn RATIO this decision window
        self._count = 0
        self._budgeted = 0

    def observe(self, total_s: float, budget_s: float) -> Optional[str]:
        """One finished total latency against ITS budget; returns
        ``"shrink"``/``"widen"`` when this observation completed a
        decision window that moved the window, else None."""
        if budget_s > 0:
            self._worst = max(self._worst, float(total_s) / budget_s)
            self._budgeted += 1
        self._count += 1
        if self._count < self.decide_every:
            return None
        worst, budgeted = self._worst, self._budgeted
        self._worst = 0.0
        self._count = 0
        self._budgeted = 0
        if budgeted == 0:
            return None  # nothing to judge against: hold
        if worst > 1.0 and self.window_s > self.floor_s:
            self.window_s = max(self.floor_s, self.window_s * self.beta)
            self.shrinks += 1
            return "shrink"
        if worst <= 0.5 and self.window_s < self.ceiling_s:
            self.window_s = min(
                self.ceiling_s, self.window_s + self.step_s
            )
            self.widens += 1
            return "widen"
        return None


# ---------------------------------------------------------------------------
# overload controller (priority shedding with hysteresis)
# ---------------------------------------------------------------------------


class OverloadController:
    """Sustained-burn shed controller.

    Tracks an EWMA of the deadline-budget burn ratio of every finished
    request (delivered total / budget; a queued-deadline cancel counts
    at its actual overrun — the SLO melted either way).  Levels:

    * 0 — healthy, nothing shed
    * 1 — ``low``-priority admissions shed (EWMA >= ``enter[0]``)
    * 2 — ``normal`` + ``low`` shed (EWMA >= ``enter[1]``); ``high``
      is never shed — only queue/quota ``Rejected`` can refuse it

    Breaker-style hysteresis: escalation is immediate (overload is an
    emergency), de-escalation requires the EWMA below the level's
    ``exit`` threshold AND ``dwell_s`` elapsed since the last change,
    so an oscillating burn near a threshold cannot flap the level.
    While shedding, :meth:`window_factor` shrinks the coalesce window
    (``shrink ** level``) — under overload the service stops lingering
    for company; on recovery the factor restores to 1.

    Recovery needs a signal even when shedding refuses ALL traffic:
    refused requests never execute, so nothing feeds the EWMA and a
    latched level would shed forever after the load vanished.
    :meth:`tick` (called at every admission) treats observation
    silence as evidence of no load: each idle ``dwell_s`` since the
    last burn sample halves the EWMA, and the normal dwelled
    de-escalation logic then runs — a flood that stops is forgiven in
    a few dwell windows, no probe traffic or restart required."""

    __slots__ = (
        "enter", "exit", "alpha", "dwell_s", "shrink",
        "level", "ewma", "observations", "_t_changed", "_t_observed",
    )

    def __init__(
        self,
        enter: Tuple[float, float] = (0.9, 1.5),
        exit: Tuple[float, float] = (0.5, 1.0),
        alpha: float = 0.25,
        dwell_s: float = 0.25,
        shrink: float = 0.25,
    ):
        if not (exit[0] < enter[0] and exit[1] < enter[1]):
            raise ValueError(
                "hysteresis requires exit thresholds below enter "
                f"thresholds (enter={enter}, exit={exit})"
            )
        self.enter = (float(enter[0]), float(enter[1]))
        self.exit = (float(exit[0]), float(exit[1]))
        self.alpha = float(alpha)
        self.dwell_s = float(dwell_s)
        self.shrink = float(shrink)
        # controller state advances under the admission plane's lock
        # (observe()/tick() callers hold it); `level` is additionally
        # READ lock-free on deliberately racy fast paths — those sites
        # carry their own justification + lint suppression
        self.level = 0  # guarded by: _lock (external)
        self.ewma = 0.0  # guarded by: _lock (external)
        self.observations = 0  # guarded by: _lock (external)
        self._t_changed = -math.inf  # guarded by: _lock (external)
        self._t_observed = -math.inf  # guarded by: _lock (external)

    def _retarget(self, now: float) -> Optional[Tuple[int, int]]:
        """Re-evaluate the level against the current EWMA (escalation
        immediate, de-escalation dwelled); returns the transition."""
        target = self.level
        while target < 2 and self.ewma >= self.enter[target]:
            target += 1
        while target > 0 and self.ewma < self.exit[target - 1]:
            target -= 1
        if target == self.level:
            return None
        if target < self.level and now - self._t_changed < self.dwell_s:
            return None  # recover slowly: dwell out the de-escalation
        old, self.level = self.level, target
        self._t_changed = now
        return (old, target)

    def observe(self, burn: float, now: float) -> Optional[Tuple[int, int]]:
        """Fold one burn ratio in; returns ``(old, new)`` when the shed
        level transitioned, else None."""
        self.ewma += self.alpha * (float(burn) - self.ewma)
        self.observations += 1
        self._t_observed = now
        return self._retarget(now)

    def tick(self, now: float) -> Optional[Tuple[int, int]]:
        """Idle decay: with the level raised and NO burn samples for a
        whole ``dwell_s``, halve the EWMA once per elapsed dwell window
        and re-evaluate — the anti-latch path (see class docstring).
        Escalation is impossible here (the EWMA only shrinks)."""
        if self.level == 0:
            return None
        idle = now - self._t_observed
        if idle < self.dwell_s:
            return None
        steps = int(idle / self.dwell_s)
        self.ewma *= 0.5 ** steps
        # consume the decayed idle time so a stream of ticks decays
        # once per dwell window, not once per admission attempt
        self._t_observed += steps * self.dwell_s
        return self._retarget(now)

    def sheds(self, priority: int) -> bool:
        """Whether an admission of this priority class is shed at the
        current level (lowest-priority-first; ``high`` never)."""
        return (
            self.level > 0 and priority >= len(PRIORITIES) - self.level
        )

    def window_factor(self) -> float:
        """Coalesce-window multiplier under overload (1.0 healthy)."""
        return self.shrink ** self.level if self.level else 1.0

    @staticmethod
    def shed_names(level: int) -> List[str]:
        """Priority-class names shed at ``level`` (lowest-first,
        ``high`` never) — the ONE spelling of the shed threshold, used
        by :meth:`sheds`' consumers that report class lists (health
        snapshot, overload span instants)."""
        if level <= 0:
            return []
        return [
            p for i, p in enumerate(PRIORITIES)
            if i >= len(PRIORITIES) - level
        ]


# ---------------------------------------------------------------------------
# the admission plane
# ---------------------------------------------------------------------------


#: per-tenant health/report counter keys (ints in the control plane so
#: health() works with metrics off; mirrored into serve.tenant.<id>.*)
_EVENTS = ("admitted", "shed", "rejected")


@dataclass
class _TenantState:
    cfg: TenantConfig
    bucket: Optional[TokenBucket] = None
    counts: Dict[str, int] = field(
        default_factory=lambda: {k: 0 for k in _EVENTS}
    )
    burn: Dict[str, int] = field(
        default_factory=lambda: {
            "requests": 0, "over_50": 0, "over_80": 0, "exhausted": 0,
        }
    )


class AdmissionControl:
    """The service's admission plane: tenant resolution + quotas +
    priority shedding + per-bucket adaptive windows.  One instance per
    :class:`~slate_tpu_torch.serve.service.SolverService`; None (the
    ``from_options`` result with nothing configured) means the plane
    is OFF and the service behaves byte-identically to the
    pre-admission tier."""

    def __init__(
        self,
        tenants: Optional[Dict[str, TenantConfig]] = None,
        adaptive: bool = False,
        budget_s: float = 0.0,
        ceiling_s: float = 0.002,
        overload: Optional[OverloadController] = None,
        clock=time.monotonic,
    ):
        self.tenancy = bool(tenants)
        self.configs: Dict[str, TenantConfig] = dict(tenants or {})
        self.adaptive = bool(adaptive)
        self.budget_s = float(budget_s or 0.0)
        self.ceiling_s = float(ceiling_s)
        self.overload = overload or OverloadController()
        self.clock = clock
        # sync.Lock: plain threading.Lock unless SLATE_TPU_SYNC_CHECK
        # armed the race plane (zero overhead off)
        self._lock = sync.Lock(name="admission.AdmissionControl._lock")
        self._states: Dict[str, _TenantState] = {}  # guarded by: _lock
        self._windows: Dict[str, AdaptiveWindow] = {}  # guarded by: _lock
        self._capped = metrics.CappedKeys(TENANT_METRIC_CAP)
        # resolved-config memo for UNNAMED tenants: config_for sits in
        # the scheduler hot path (every FairQueue pop, under the
        # service lock) — rebuilding + revalidating a frozen dataclass
        # per dispatch is waste.  Bounded like _states (cleared, not
        # LRU'd: it only ever holds default-template clones)
        self._cfg_cache: Dict[str, TenantConfig] = {}

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_options(
        opts=None,
        tenants=None,
        adaptive: Optional[bool] = None,
        budget_s: Optional[float] = None,
        ceiling_s: float = 0.002,
        clock=time.monotonic,
    ) -> Optional["AdmissionControl"]:
        """Resolve the admission plane from explicit arguments, the
        Serve* options, and the env (:data:`TENANTS_ENV` /
        :data:`ADAPTIVE_ENV`); returns None when nothing is configured
        — the zero-overhead default."""
        from ..enums import Option
        from ..options import get_option

        if tenants is None:
            tenants = (
                get_option(opts, Option.ServeTenantQuota)
                or os.environ.get(TENANTS_ENV, "")
            )
        if isinstance(tenants, str):
            tenants = parse_tenants(tenants) if tenants.strip() else {}
        # SLATE_TPU_ADAPTIVE: "1"/"true" = on (budget from options);
        # a float = on with that p99 budget in seconds; "0"/"" = off.
        # Malformed values fail naming the knob (the faults-env rule:
        # silently ignoring a spec the operator believes active is
        # worse than refusing to start).
        env_adaptive = os.environ.get(ADAPTIVE_ENV, "").strip().lower()
        env_budget = 0.0
        env_on = False
        if env_adaptive and env_adaptive not in ("0", "false", "off"):
            env_on = True
            if env_adaptive not in ("1", "true", "on"):
                try:
                    env_budget = float(env_adaptive)
                except ValueError:
                    raise ValueError(
                        f"{ADAPTIVE_ENV}={env_adaptive!r}: expected 1 "
                        "or a p99 budget in seconds"
                    ) from None
                if env_budget <= 0:
                    # "0.0"/"0.00" mean off, same as "0" — arming the
                    # plane with a budget no controller can use would
                    # be pure overhead the operator asked to avoid
                    env_on = False
                    env_budget = 0.0
        if adaptive is None:
            adaptive = bool(
                get_option(opts, Option.ServeAdaptiveWindow) or env_on
            )
        if budget_s is None:
            budget_s = float(
                get_option(opts, Option.ServeLatencyBudget)
                or env_budget or 0.0
            )
        if not tenants and not adaptive:
            return None
        return AdmissionControl(
            tenants=tenants, adaptive=bool(adaptive),
            budget_s=float(budget_s), ceiling_s=float(ceiling_s),
            clock=clock,
        )

    def new_queue(self) -> FairQueue:
        """A weighted-fair lane queue bound to this plane's weights."""
        return FairQueue(self)

    # -- tenants ------------------------------------------------------------

    def config_for(self, tenant: str) -> TenantConfig:
        """The named tenant's config; unnamed tenants inherit the
        ``default`` entry (or the built-in defaults).  Memoized: this
        sits in the scheduler hot path."""
        cfg = self.configs.get(tenant)
        if cfg is not None:
            return cfg
        cfg = self._cfg_cache.get(tenant)
        if cfg is None:
            tmpl = self.configs.get(DEFAULT_TENANT)
            cfg = (
                TenantConfig(
                    name=tenant, weight=tmpl.weight, rate=tmpl.rate,
                    burst=tmpl.burst, share=tmpl.share,
                )
                if tmpl is not None else TenantConfig(name=tenant)
            )
            if len(self._cfg_cache) >= TENANT_STATE_CAP:
                self._cfg_cache.clear()  # churning ids: bounded, cheap
            self._cfg_cache[tenant] = cfg
        return cfg

    def _state_locked(self, tenant: str) -> _TenantState:
        # _locked suffix: the caller holds self._lock
        st = self._states.get(tenant)
        if st is None:
            cfg = self.config_for(tenant)
            st = _TenantState(cfg=cfg)
            if cfg.rate > 0:
                st.bucket = TokenBucket(
                    cfg.rate, cfg.capacity, now=self.clock()
                )
            if len(self._states) >= TENANT_STATE_CAP:
                # bounded control-plane memory (TENANT_STATE_CAP): a
                # churning caller-controlled id stream must not leak
                # one _TenantState per id forever.  Evict the oldest
                # unconfigured id (insertion order); an evicted tenant
                # that returns starts fresh — the same tradeoff the
                # metric cap makes, here trading its old counters and
                # a refilled bucket for boundedness
                for old in self._states:
                    if old not in self.configs:
                        del self._states[old]
                        break
            self._states[tenant] = st
        return st

    def tenant_event(self, tenant: str, event: str, n: int = 1) -> None:
        """Count one per-tenant admission event (health ints + the
        capped ``serve.tenant.<id>.<event>`` metric family)."""
        with self._lock:
            st = self._state_locked(tenant)
            st.counts[event] = st.counts.get(event, 0) + n
        if metrics.is_on():
            if self._capped.track(tenant):
                metrics.inc(f"serve.tenant.{tenant}.{event}", n)
            else:
                metrics.inc("serve.tenant_overflow", n)

    def quota_take(self, tenant: str, now: float) -> bool:
        """One admission against the tenant's token bucket (True =
        admitted; unlimited tenants always pass)."""
        with self._lock:
            st = self._state_locked(tenant)
            if st.bucket is None:
                return True
            return st.bucket.take(now)

    def share_limit(self, tenant: str, max_queue: int) -> int:
        """This tenant's queue-occupancy cap in requests."""
        share = self.config_for(tenant).share
        if share >= 1.0:
            return int(max_queue)
        return max(1, int(share * max_queue))

    def sheds(self, priority: int) -> bool:
        return self.overload.sheds(priority)

    def tick(self, now: float) -> None:
        """Admission-time anti-latch hook: give the overload controller
        a chance to decay an idle EWMA and de-escalate even when
        shedding refuses every request that would otherwise feed it
        (``OverloadController.tick``)."""
        # lock-free steady state: tick only ever LOWERS the level, so a
        # racy read that misses a just-raised level merely defers the
        # (no-op-at-0 anyway) decay to the next submit
        if self.overload.level == 0:
            return
        with self._lock:
            moved = self.overload.tick(now)
        self._emit_overload(moved)

    def _emit_overload(
        self, moved: Optional[Tuple[int, int]],
        trace: Optional[str] = None, lane: Optional[str] = None,
    ) -> None:
        """Metrics + span instant for one shed-level transition."""
        if moved is None:
            return
        old, new = moved
        metrics.gauge("serve.overload.level", new)
        metrics.inc(
            "serve.overload.enter" if new > old else "serve.overload.exit"
        )
        if spans.is_on():
            spans.event(
                "overload_enter" if new > old else "overload_exit",
                trace=trace, lane=lane, level=new,
                sheds=OverloadController.shed_names(new),
            )

    # -- the control loop ---------------------------------------------------

    def window_for(self, label: str) -> float:
        """The coalesce window one lane should linger for this bucket:
        the AIMD window (ceiling when adaptation is off) times the
        overload shrink factor."""
        if self.adaptive:
            with self._lock:
                w = self._windows.get(label)
                win = w.window_s if w is not None else self.ceiling_s
        else:
            win = self.ceiling_s
        return win * self.overload.window_factor()

    def _window_locked(self, label: str) -> AdaptiveWindow:
        w = self._windows.get(label)
        if w is None:
            w = self._windows[label] = AdaptiveWindow(self.ceiling_s)
            if metrics.is_on():
                metrics.gauge(f"serve.adaptive.{label}.window_s", w.window_s)
        return w

    def observe_finish(
        self,
        label: Optional[str],
        tenant: str,
        priority: int,
        total_s: float,
        budget_s: Optional[float],
        now: float,
        trace: Optional[str] = None,
        lane: Optional[str] = None,
        windowed: bool = True,
    ) -> None:
        """One finished request into the control loop: per-tenant burn
        accounting + latency histogram, the overload EWMA (shed-level
        transitions are metric'd + span-instant'd), and — with
        adaptation on — the bucket's AIMD window decision.
        ``windowed=False`` skips the window (direct-only and sharded
        requests never coalesce, so tuning a window nothing consults
        would be pure gauge noise)."""
        budget = (
            float(budget_s) if budget_s is not None and budget_s > 0
            else self.budget_s
        )
        burn = (total_s / budget) if budget > 0 else None
        tracked = metrics.is_on() and self._capped.track(tenant)
        if tracked:
            metrics.observe_hist(
                f"serve.latency.tenant.{tenant}.total", total_s
            )
        with self._lock:
            st = self._state_locked(tenant)
            if burn is not None:
                # the per-tenant twin of the service-wide slo_burn
                # tiers: each finished deadline request lands in one
                st.burn["requests"] += 1
                tier = (
                    "exhausted" if burn > 1.0
                    else "over_80" if burn > 0.8
                    else "over_50" if burn > 0.5
                    else None
                )
                if tier:
                    st.burn[tier] += 1
                if tracked:
                    metrics.inc(f"serve.tenant.{tenant}.slo_burn.requests")
                    if tier:
                        metrics.inc(
                            f"serve.tenant.{tenant}.slo_burn.{tier}"
                        )
            moved = (
                self.overload.observe(burn, now)
                if burn is not None else None
            )
            decision = None
            win = None
            if self.adaptive and windowed and label is not None \
                    and budget > 0:
                w = self._window_locked(label)
                decision = w.observe(total_s, budget)
                win = w.window_s
        self._emit_overload(moved, trace=trace, lane=lane)
        if decision is not None:
            if metrics.is_on():
                # adaptation runs with or without the registry; the
                # per-bucket f-string names are only built when it is on
                metrics.gauge(f"serve.adaptive.{label}.window_s", win)
                metrics.inc(f"serve.adaptive.{label}.{decision}")
            metrics.inc("serve.adaptive.changes")
            spans.event(
                "adaptive_window", trace=trace, lane=lane, bucket=label,
                window_s=round(win, 6), direction=decision,
            )

    # -- health -------------------------------------------------------------

    def tenants_health(
        self, depths: Dict[str, int], now: Optional[float] = None
    ) -> Dict[str, dict]:
        """The per-tenant ``health()`` section: queue depth, quota
        remaining, weight, admitted/shed/rejected counts, and the
        per-tenant burn tiers.  ``depths`` is the service's summed
        per-lane queue depth per tenant."""
        now = self.clock() if now is None else now
        with self._lock:
            names = set(self._states) | set(self.configs) | set(depths)
            out = {}
            for t in sorted(names):
                st = self._states.get(t)
                cfg = st.cfg if st is not None else self.config_for(t)
                out[t] = {
                    "depth": int(depths.get(t, 0)),
                    "weight": cfg.weight,
                    "share": cfg.share,
                    "quota_remaining": (
                        st.bucket.remaining(now)
                        if st is not None and st.bucket is not None
                        else None
                    ),
                    **{
                        k: (st.counts.get(k, 0) if st is not None else 0)
                        for k in _EVENTS
                    },
                    "burn": dict(st.burn) if st is not None else {
                        "requests": 0, "over_50": 0, "over_80": 0,
                        "exhausted": 0,
                    },
                }
            return out

    def snapshot(self) -> dict:
        """Controller state for ``health()["admission"]``."""
        with self._lock:
            # one consistent controller snapshot: level and EWMA read
            # under the same lock that advances them (a probe racing a
            # transition must not report level 2 beside a level-0 EWMA)
            windows = {
                lbl: round(w.window_s, 6)
                for lbl, w in self._windows.items()
            }
            lvl = self.overload.level
            ewma = self.overload.ewma
        return {
            "tenancy": self.tenancy,
            "adaptive": self.adaptive,
            "budget_s": self.budget_s,
            "overload_level": lvl,
            "shedding": OverloadController.shed_names(lvl),
            "burn_ewma": round(ewma, 4),
            "windows": windows,
        }
