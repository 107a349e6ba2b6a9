"""Thin sync serving API over one process-wide :class:`SolverService`
(the JAX package's ``serve/api.py``), or over the process's fleet router
when ``SLATE_TPU_FLEET`` is set.

Usage::

    from slate_tpu_torch import serve

    X = serve.gesv(A, B)               # sync; pads/crops + batches on cuda:0
    fut = serve.submit("posv", S, B, deadline=0.2, retries=1)
    X2 = fut.result()

Inputs are plain numpy (m, n) / (m, nrhs) arrays and results come back
as numpy: the serving boundary is arrays, the bucket decides the tile
layout.  ``posv`` solves with the lower triangle of A; ``gels`` with
m < n is served by the direct driver.  A nonzero driver ``info`` raises
NumericalError from ``.result()``; deadline misses raise
DeadlineExceeded; a full queue (or, with tenants configured, a tenant's
quota or queue share) raises Rejected, the overload controller's
refusal raises Shed, and non-finite operands raise InvalidInput from
``submit`` itself.  ``tenant=`` / ``priority=`` tag a request for the
admission plane (``SLATE_TPU_TENANTS`` / ``SLATE_TPU_ADAPTIVE``, or
``configure(tenants=..., adaptive=...)``).  ``session(A)`` opens a
streaming least-squares session (``fabric/session.py``), and
``get_arena()`` returns the device factor arena (``fabric/arena.py``,
``SLATE_TPU_FACTOR_ARENA`` / ``Option.ServeFactorArena``), or None.
With ``SLATE_TPU_FLEET`` set (``fleet/router.py``), ``submit``,
``health`` and ``shutdown`` go through the router built at import
(``get_fleet()``); unset, the fleet package is not imported and each of
them pays one ``is None`` branch.

The default service reads the Serve* Option defaults; ``configure()``
overrides them per process (``configure(placement=PlacementPolicy(
devices=[torch.device("cpu")]))`` serves on the CPU).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future
from typing import Optional

import numpy as np

from ..aux import sync
from ..enums import Option
from ..exceptions import InvalidInput  # noqa: F401  (re-export: taxonomy)
from ..options import Options, get_option
from .cache import ExecutableCache
from .service import DeadlineExceeded, Rejected, Shed, SolverService  # noqa: F401

_lock = threading.Lock()
_service: Optional[SolverService] = None

# fleet tier (SLATE_TPU_FLEET): with the env unset this stays None and
# every call below pays exactly one ``is None`` branch; the fleet package
# is not even imported
_fleet = None
if os.environ.get("SLATE_TPU_FLEET"):
    from ..fleet.router import FleetRouter

    _fleet = FleetRouter.from_env()


def get_service() -> SolverService:
    """The process-wide service (started on first use)."""
    global _service
    with _lock:
        if _service is None:
            _service = _make_service(None)
        return _service


def _make_service(opts: Optional[Options], **kw) -> SolverService:
    from .factor_cache import cache_from_options
    from .placement import PlacementPolicy

    cfg = dict(
        max_queue=int(get_option(opts, Option.ServeQueueLimit)),
        batch_max=int(get_option(opts, Option.ServeBatchMax)),
        batch_window_s=float(get_option(opts, Option.ServeBatchWindow)),
        retry_backoff_s=float(get_option(opts, Option.ServeRetryBackoff)),
        breaker_cooldown_s=float(get_option(opts, Option.ServeBreakerCooldown)),
        validate=bool(get_option(opts, Option.ServeValidate)),
        schedule=get_option(opts, Option.Schedule),
        precision=str(get_option(opts, Option.ServePrecision) or "full"),
        faults_spec=str(get_option(opts, Option.Faults) or ""),
    )
    # the planes pass through only when explicitly set, so an explicit
    # off value in opts wins over the env
    _unset = object()
    for name, key, conv in (("tenants", Option.ServeTenantQuota, lambda v: v),
                            ("adaptive", Option.ServeAdaptiveWindow, bool),
                            ("latency_budget_s", Option.ServeLatencyBudget, float),
                            ("integrity", Option.ServeIntegrity, lambda v: v or False)):
        v = get_option(opts, key, _unset)
        cfg[name] = None if v is _unset else conv(v)
    cfg.update(kw)
    if cfg.get("factor_cache") is None:
        # per-call opts can enable the factor cache too
        cfg["factor_cache"] = cache_from_options(opts)
    if cfg.get("factor_arena") is None and opts:
        # an explicit opts spec builds (or explicitly disables) the arena
        # here; otherwise the service resolves the env and the defaults
        fa = get_option(opts, Option.ServeFactorArena, _unset)
        if fa is not _unset:
            if isinstance(fa, str):
                from ..fabric.arena import FactorArena, parse_arena_spec

                spec = parse_arena_spec(fa)
                cfg["factor_arena"] = FactorArena(**spec) if spec is not None else False
            else:
                cfg["factor_arena"] = fa or False
    if cfg.get("placement") is None:
        cfg["placement"] = PlacementPolicy.from_options(opts, replicas=cfg.pop("replicas", None))
    return SolverService(**cfg)


def configure(opts: Optional[Options] = None, **kw) -> SolverService:
    """Rebuild the process service (stops the old one).  ``kw`` are
    :class:`SolverService` arguments; ``opts`` resolves the Serve*
    options.  Returns the new service."""
    global _service
    with _lock:
        if _service is not None:
            _service.stop()
        _service = _make_service(opts, **kw)
        return _service


def shutdown() -> None:
    """Stop the process service (idempotent; a later call re-creates).
    With the fleet tier on, drains the router (and its workers) too."""
    global _service
    if _fleet is not None:
        _fleet.stop(drain=True)
    with _lock:
        if _service is not None:
            _service.stop()
            _service = None


def warmup(path: Optional[str] = None, verbose: bool = False) -> int:
    """Cold-build the warmup manifest's executables (``path`` or the
    cache's ``SLATE_TPU_WARMUP`` manifest) on the lane's device; returns
    the number built.  After it, requests in those buckets make no cold
    build."""
    return get_service().warmup(path=path, verbose=verbose)


def restore(verbose: bool = False, timeout: Optional[float] = None) -> dict:
    """Bring the warmed set live artifact-first (each manifest entry
    restored from the ``SLATE_TPU_ARTIFACTS`` store where a verified
    entry exists, built otherwise, and primed on every lane's device).
    Returns the restore summary ``{"entries", "restored", "compiled",
    "failed", "skipped"}``.  A service with a store runs this on start;
    that pass is waited out first (bounded by ``timeout``), and a pass
    still running at the bound raises TimeoutError rather than start a
    second one beside it."""
    svc = get_service()
    if not svc.wait_ready(timeout):
        h = svc.health()
        if h["phase"] == "restoring":
            raise TimeoutError(
                f"start-time restore still running after {timeout:g}s "
                f"(restore_stuck_s={h['restore_stuck_s']}); not starting a "
                "concurrent pass")
    return svc.restore(verbose=verbose)


def wait_ready(timeout: Optional[float] = None) -> bool:
    """Block until the process service reaches the ``ready`` phase (its
    start-time restore pass finished); False on timeout."""
    return get_service().wait_ready(timeout)


def submit(routine: str, A, B, deadline: Optional[float] = None, retries: int = 0,
           precision: Optional[str] = None, sharded: Optional[bool] = None,
           tenant: Optional[str] = None, priority=None) -> Future:
    """Async entry: enqueue and return the Future (see
    :meth:`SolverService.submit`).  With ``SLATE_TPU_FLEET`` set the
    request routes through the process's
    :class:`~slate_tpu_torch.fleet.FleetRouter`: the same Future contract
    and typed taxonomy, plus the fabric's own
    :class:`~slate_tpu_torch.fleet.HostDead` /
    :class:`~slate_tpu_torch.fleet.FleetTimeout`."""
    if _fleet is not None:
        return _fleet.submit(routine, A, B, deadline=deadline, retries=retries,
                             precision=precision, sharded=sharded, tenant=tenant,
                             priority=priority)
    return get_service().submit(routine, A, B, deadline=deadline, retries=retries,
                                precision=precision, sharded=sharded, tenant=tenant,
                                priority=priority)


def _sync(routine, A, B, deadline, retries, precision=None, sharded=None, tenant=None,
          priority=None) -> np.ndarray:
    fut = submit(routine, A, B, deadline=deadline, retries=retries, precision=precision,
                 sharded=sharded, tenant=tenant, priority=priority)
    # the worker resolves every admitted future, so this cannot hang
    try:
        return fut.result()
    finally:
        sync.hb_receive(fut)


def gesv(A, B, deadline: Optional[float] = None, retries: int = 0,
         precision: Optional[str] = None, sharded: Optional[bool] = None,
         tenant: Optional[str] = None, priority=None) -> np.ndarray:
    """Solve A X = B (square, LU with partial pivoting) through the
    service; returns X (n x nrhs).  ``precision="mixed"`` takes a
    mixed-precision bucket."""
    return _sync("gesv", A, B, deadline, retries, precision, sharded, tenant, priority)


def posv(A, B, deadline: Optional[float] = None, retries: int = 0,
         precision: Optional[str] = None, sharded: Optional[bool] = None,
         tenant: Optional[str] = None, priority=None) -> np.ndarray:
    """Solve SPD A X = B (Cholesky, lower triangle referenced)."""
    return _sync("posv", A, B, deadline, retries, precision, sharded, tenant, priority)


def gels(A, B, deadline: Optional[float] = None, retries: int = 0,
         tenant: Optional[str] = None, priority=None) -> np.ndarray:
    """Least squares min ||A X - B|| (m >= n batched; m < n direct)."""
    return _sync("gels", A, B, deadline, retries, tenant=tenant, priority=priority)


def health() -> dict:
    """Liveness/readiness snapshot of the process service (see
    :meth:`SolverService.health`): with the admission plane on, its
    ``tenants`` and ``admission`` sections; with the device monitor on
    (``SLATE_TPU_DEVMON=1``), ``devices`` and ``cost``; with tracing on,
    ``trace_ring``.  With the fleet tier on, the router's snapshot
    instead: per-host breaker states and integrity scores, the pending
    count and the global admission plane (:meth:`FleetRouter.health`)."""
    if _fleet is not None:
        return _fleet.health()
    return get_service().health()


def get_fleet():
    """The process's :class:`~slate_tpu_torch.fleet.FleetRouter`, or None
    without ``SLATE_TPU_FLEET`` (the single-process path)."""
    return _fleet


def get_cache() -> ExecutableCache:
    """The process service's executable cache (manifest control)."""
    return get_service().cache


def get_factor_cache():
    """The process service's FactorCache, or None when disabled (the
    default; ``SLATE_TPU_FACTOR_CACHE=1`` / ``Option.ServeFactorCache``
    turn it on)."""
    return get_service().factor_cache


def factor_fingerprint(routine: str, A) -> str:
    """The fingerprint ``submit(routine, A, ...)`` keys the factor cache
    by — the handle for :func:`invalidate` / :func:`update_factor`."""
    from .factor_cache import matrix_fingerprint

    return matrix_fingerprint(np.asarray(A), routine, schedule=get_service().schedule)


def invalidate(fp: str) -> bool:
    """Drop one fingerprint's cached factor (the next same-A request
    pays a counted refactor) and its device-arena residency.  False when
    absent or the cache is off."""
    svc = get_service()
    if svc.arena is not None:
        svc.arena.drop(fp)
    fc = svc.factor_cache
    return fc.invalidate(fp) if fc is not None else False


def invalidate_all() -> int:
    """Drop every cached factor and all device-arena residency; the count
    dropped (0 when off)."""
    svc = get_service()
    if svc.arena is not None:
        svc.arena.clear()
    fc = svc.factor_cache
    return fc.invalidate_all() if fc is not None else 0


def update_factor(fp: str, A_new, U, downdate: bool = False):
    """Rank-k up/downdate of a cached factor for ``A_new = A ± U U^H``:
    posv entries update the Cholesky factor in O(k n^2), gesv entries
    refactor (counted).  Returns the new fingerprint, or None when ``fp``
    is not cached or the cache is off."""
    fc = get_service().factor_cache
    if fc is None:
        return None
    return fc.update(fp, np.asarray(A_new), np.asarray(U), downdate=downdate)


# -- factor fabric (device arena + streaming sessions) -----------------------


def get_arena():
    """The process service's
    :class:`~slate_tpu_torch.fabric.arena.FactorArena`, or None when
    unarmed (the default; ``SLATE_TPU_FACTOR_ARENA=1`` / ``bytes=<N>`` /
    ``Option.ServeFactorArena`` arm it, with the factor cache on)."""
    return get_service().arena


def session(A, routine: str = "gels", schedule: Optional[str] = None):
    """Open a streaming factor-reuse session on the process service
    (:class:`~slate_tpu_torch.fabric.session.FactorSession`)::

        s = serve.session(A)          # min ||A x - b||, m >= n
        x0 = s.solve(b)               # pristine: factor cache / arena path
        s.append(rows)                # O(k n^2) Householder update of R
        x1 = s.solve(b_grown)         # fenced CSNE against the updated R

    Every streamed solve passes the residual fence or pays a counted
    refactor (``fabric.session.refactor``), never a wrong X."""
    from ..fabric.session import FactorSession

    svc = get_service()
    return FactorSession(svc, A, routine=routine,
                         schedule=svc.schedule if schedule is None else schedule)
