"""Deterministic, seedable fault injection: the part of the JAX
package's ``aux/faults.py`` that the drivers and the serve tier use.
The fleet sites (``host_death``, ``host_partition``, ``rpc_timeout``)
belong to the plane not ported yet (ROADMAP.md Queue 1 item 7c3).

Sites (:data:`SITES`) and where they are checked:

    ``compile``        a bucket's cold build fails
                       (``serve.cache.ExecutableCache.executable``)
    ``execute``        dispatch raises (``cache.run`` / ``direct_call``)
    ``result_corrupt`` NaN poisoned into the first batch item's output
                       (``cache.run``) / into the low-precision factor
                       (``drivers/mixed`` factor step)
    ``latency``        injected sleep before dispatch, ``ms=`` spec key
                       (``cache.run`` / ``direct_call``)
    ``worker_death``   the service worker thread dies mid-loop with a
                       batch in flight (``service.SolverService._loop``)
    ``info_nonzero``   the first batch item's ``info`` forced nonzero,
                       ``info=`` spec key (``cache.run``); also a fake
                       nonzero factor info in the mixed drivers
    ``factor_stale``   a factor-cache hit serves a factor whose first
                       element is silently wrong (finite): the hit
                       path's residual validation must catch it
                       (``serve.service`` solve-phase dispatch)
    ``session_update`` a streaming session's Householder update of R
                       silently wrong (finite) after the fold
                       (``fabric.session.FactorSession.append``): the
                       per-solve residual fence must catch it and pay a
                       counted refactor
    ``artifact_corrupt``   one byte of an artifact flipped as it is read
    ``artifact_stale``     an artifact's fingerprint read as another
                           runtime's
    ``artifact_load_fail`` a verified artifact fails to load
                           (``serve.artifacts.ArtifactStore.load``)
    ``sdc_factor``     a fresh factor's first element silently wrong
                       (``serve.service`` factor path)
    ``sdc_solve``      a delivered gesv/posv X's first element silently
                       wrong (``cache.run``): only delivery certification
                       (``integrity/``) can catch either
    ``lock_contend``   injected sleep inside checked lock acquisitions
                       (``aux/sync``, armed by ``SLATE_TPU_SYNC_CHECK``),
                       ``ms=`` spec key; inert while the checker is off
    ``tenant_flood``   a burst of ``burst=`` low-priority requests from
                       tenant ``"flood"`` cloning the triggering
                       request, injected at admission on a
                       tenancy-enabled service (``service._submit``):
                       quotas and shedding must refuse it

Triggers (exactly one per site): probability ``p=0.2`` (seeded RNG per
site, so the fire pattern is a pure function of ``seed`` and the call
sequence), every-Nth call ``every=3``, or ``once`` (fires on the
``after=N``-th call, default the first, then never again).

One module-level bool gates every entry point, so with faults off each
site costs a single bool check.  Every injection increments
``faults.injected.<site>`` in the metrics registry and the site's local
stats (:func:`stats`).  The poisoning helpers take a numpy array or a
tensor and return a fresh copy of the same kind, on its own device::

    SLATE_TPU_FAULTS="execute:p=0.2,seed=7;worker_death:every=9" python app.py

Spec grammar (``SLATE_TPU_FAULTS`` / ``Option.Faults`` / :func:`configure`)::

    spec      := site_spec (';' site_spec)*
    site_spec := site ':' item (',' item)*
    item      := 'p=<float>' | 'every=<int>' | 'once'
               | 'after=<int>' | 'seed=<int>' | 'ms=<float>' | 'info=<int>'
               | 'burst=<int>'
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..exceptions import SlateError
from . import metrics



@dataclass(frozen=True)
class SiteSpec:
    """One fault site's contract: the counter families whose sum is its
    recovery signal (what absorbed the injection), and whether a zero
    recovery is legitimate (``informational``).  The JAX package's
    registry, restricted to the sites ported."""

    name: str
    recovery: Tuple[str, ...] = ()
    informational: bool = False


SITE_SPECS: Tuple[SiteSpec, ...] = (
    SiteSpec("compile", recovery=("serve.fallbacks", "serve.retries")),
    SiteSpec("execute", recovery=("serve.retries", "serve.fallbacks", "serve.breaker_open")),
    SiteSpec("result_corrupt", recovery=("serve.corrupt_result", "serve.fallbacks")),
    SiteSpec("latency", recovery=("serve.deadline_miss_late",), informational=True),
    SiteSpec("worker_death", recovery=("serve.worker_restarts",)),
    SiteSpec("info_nonzero", recovery=("serve.numerical_errors",)),
    # detection == containment for the artifact load ladder: a counted
    # rung means the bad artifact was rebuilt, not served
    SiteSpec("artifact_corrupt", recovery=("serve.artifact_corrupt",)),
    SiteSpec("artifact_stale", recovery=("serve.artifact_stale",)),
    SiteSpec("artifact_load_fail", recovery=("serve.artifact_load_fail",)),
    SiteSpec("factor_stale", recovery=("serve.factor_cache.stale",)),
    # the per-solve residual fence catches a poisoned R update and the
    # counted refactor rebuilds it from A, never a silent wrong X
    SiteSpec("session_update", recovery=("fabric.session.fence_fail",
                                         "fabric.session.refactor")),
    # a counted certificate failure means the wrong X was re-executed,
    # never delivered; hits on a factor poisoned by sdc_factor land on
    # the factor cache's residual fence (stale)
    SiteSpec("sdc_factor", recovery=("serve.integrity.fail", "serve.integrity.recovered",
                                     "serve.factor_cache.stale")),
    SiteSpec("sdc_solve", recovery=("serve.integrity.fail", "serve.integrity.recovered",
                                    "serve.factor_cache.stale")),
    # added lock-hold time violates nothing by itself: deadline traffic
    # surfaces it as late misses, and a run without deadlines is a
    # legitimate zero-signal outcome
    SiteSpec("lock_contend", recovery=("serve.deadline_miss_late",), informational=True),
    # a flood is absorbed when the admission plane refused (some of) it
    SiteSpec("tenant_flood", recovery=("serve.shed", "serve.rejected_quota",
                                       "serve.rejected_share", "serve.rejected")),
)

SITE_REGISTRY: Dict[str, SiteSpec] = {s.name: s for s in SITE_SPECS}

#: site names in declaration order (derived from SITE_SPECS)
SITES: Tuple[str, ...] = tuple(s.name for s in SITE_SPECS)


class FaultInjected(SlateError):
    """An armed fault site fired (raised only under chaos testing; carries
    the site name so recovery paths can attribute the failure)."""

    def __init__(self, message: str, site: str = ""):
        super().__init__(message)
        self.site = site


@dataclass
class _Site:
    """One armed site: trigger config + live counters."""

    name: str
    p: float = 0.0
    every: int = 0
    once: bool = False
    after: int = 1
    seed: int = 0
    ms: float = 1.0  # latency-site sleep duration
    info: int = 1  # info_nonzero-site injected value
    burst: int = 8  # tenant_flood-site synthetic request count
    calls: int = 0
    fired: int = 0
    rng: random.Random = field(default_factory=random.Random)


_enabled = False
_lock = threading.RLock()
_sites: Dict[str, _Site] = {}


def on() -> None:
    """Enable injection (one bool flips; armed sites start evaluating)."""
    global _enabled
    _enabled = True


def off() -> None:
    global _enabled
    _enabled = False


def is_on() -> bool:
    return _enabled


def reset() -> None:
    """Disable and disarm everything (test teardown)."""
    global _enabled
    with _lock:
        _enabled = False
        _sites.clear()


def arm(site: str, p: float = 0.0, every: int = 0, once: bool = False,
        after: int = 1, seed: int = 0, ms: float = 1.0, info: int = 1,
        burst: int = 8) -> None:
    """Arm one site with exactly one trigger (p / every / once).  Does
    NOT enable injection — call :func:`on`."""
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r}; sites: {SITES}")
    if sum((p > 0, every > 0, bool(once))) != 1:
        raise ValueError(f"{site}: exactly one trigger of p=/every=/once required")
    s = _Site(name=site, p=float(p), every=int(every), once=bool(once), after=int(after),
              seed=int(seed), ms=float(ms), info=int(info), burst=int(burst))
    # per-site stream: the same seed arms several sites independently
    s.rng = random.Random(f"{s.seed}:{site}")
    with _lock:
        _sites[site] = s


def disarm(site: str) -> None:
    with _lock:
        _sites.pop(site, None)


def configure(spec: str) -> None:
    """Parse the spec grammar and arm each site_spec."""
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        site, sep, items = part.partition(":")
        if not sep:
            raise ValueError(f"fault spec {part!r}: expected 'site:trigger'")
        kw: dict = {}
        for item in items.split(","):
            item = item.strip()
            if not item:
                continue
            if item == "once":
                kw["once"] = True
                continue
            k, sep, v = item.partition("=")
            k, v = k.strip(), v.strip()
            if not sep:
                raise ValueError(f"fault spec item {item!r} in {part!r}")
            if k in ("p", "ms"):
                kw[k] = float(v)
            elif k in ("every", "after", "seed", "info", "burst"):
                kw[k] = int(v)
            else:
                raise ValueError(f"unknown fault spec key {k!r} in {part!r}")
        arm(site.strip(), **kw)


def fire(site: str) -> Optional[_Site]:
    """Evaluate one site's trigger: returns the site record when it
    fires, None otherwise.  The per-site call counter advances on every
    evaluation, so p-mode patterns are a deterministic function of the
    seed and the call sequence."""
    if not _enabled:
        return None
    s = _sites.get(site)
    if s is None:
        return None
    with _lock:
        s.calls += 1
        if s.once:
            hit = s.calls >= s.after and s.fired == 0
        elif s.every > 0:
            hit = s.calls % s.every == 0
        else:
            hit = s.rng.random() < s.p
        if hit:
            s.fired += 1
    if hit:
        metrics.inc(f"faults.injected.{site}")
        return s
    return None


def check(site: str) -> None:
    """Raise :class:`FaultInjected` when the site fires (the compile /
    execute / worker_death form)."""
    if not _enabled:
        return
    s = fire(site)
    if s is not None:
        raise FaultInjected(f"injected {site} fault (#{s.fired})", site=site)


def sleep(site: str = "latency") -> float:
    """Sleep ``ms`` milliseconds when the site fires; returns the seconds
    slept."""
    if not _enabled:
        return 0.0
    s = fire(site)
    if s is None:
        return 0.0
    time.sleep(s.ms / 1e3)
    return s.ms / 1e3


def _with_first(a, fn):
    """A fresh copy of ``a`` (a tensor stays on its own device) with its
    first element replaced by ``fn(first)``."""
    if isinstance(a, torch.Tensor):
        out = a.clone(memory_format=torch.contiguous_format)
    else:
        out = np.array(a, order="C")  # a fresh writable copy, flat in C order
    flat = out.view(-1) if isinstance(out, torch.Tensor) else out.reshape(-1)
    flat[0] = fn(flat[0])
    return out


def corrupt(site: str, a):
    """``a`` with its first element NaN-poisoned when the site fires
    (result_corrupt: item 0 of a batched output), unchanged otherwise."""
    if not _enabled or fire(site) is None:
        return a
    return _with_first(a, lambda _v: float("nan"))


def perturb(site: str, a):
    """``a`` with its first element perturbed to a finite wrong value
    (x -> 2x + 1) when the site fires (factor_stale, sdc_factor,
    sdc_solve), unchanged otherwise."""
    if not _enabled or fire(site) is None:
        return a
    return _with_first(a, lambda v: v * 2 + 1)


def poison_info(site: str, info):
    """Force the first entry of an ``info`` vector to the site's
    ``info=`` value when it fires, unchanged otherwise."""
    if not _enabled:
        return info
    s = fire(site)
    return info if s is None else _with_first(info, lambda _v: s.info)


def stats() -> Dict[str, dict]:
    """Per-site {calls, fired} counters for every armed site."""
    with _lock:
        return {k: {"calls": v.calls, "fired": v.fired} for k, v in _sites.items()}


# env activation, as the JAX package does it: a malformed spec fails
# naming the knob rather than silently leaving chaos disarmed
_env_spec = os.environ.get("SLATE_TPU_FAULTS")
if _env_spec:
    try:
        configure(_env_spec)
    except (ValueError, TypeError) as e:
        raise ValueError(f"SLATE_TPU_FAULTS={_env_spec!r}: {e}") from e
    on()
