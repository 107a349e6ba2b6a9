"""Deterministic, seedable fault injection: the part of the JAX
package's ``aux/faults.py`` that the mixed-precision drivers use (the
serve tier's sites come with its port, ROADMAP.md Queue 1 items 4 and 7).

Sites (:data:`SITES`) and where they are checked:

    ``result_corrupt`` NaN poisoned into element 0 of the low-precision
                       factor (``drivers/mixed`` factor step — drives the
                       refinement into its fallback solver)
    ``info_nonzero``   a fake nonzero factor info, ``info=`` value, in the
                       mixed drivers' factor step (fallback exercise)

Triggers (exactly one per site): probability ``p=0.2`` (seeded RNG per
site, so the fire pattern is a pure function of ``seed`` and the call
sequence), every-Nth call ``every=3``, or ``once`` (fires on the first
call, then never again).

One module-level bool gates every entry point, so with faults off each
site costs a single bool check.  Every injection increments
``faults.injected.<site>`` in the metrics registry and the site's local
stats (:func:`stats`)::

    from slate_tpu_torch.aux import faults
    faults.arm("info_nonzero", once=True)
    faults.on()
    ...
    faults.reset()
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from . import metrics

SITES = ("result_corrupt", "info_nonzero")


@dataclass
class _Site:
    """One armed site: trigger config + live counters."""

    name: str
    p: float = 0.0
    every: int = 0
    once: bool = False
    seed: int = 0
    info: int = 1  # info_nonzero-site injected value
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
        seed: int = 0, info: int = 1) -> None:
    """Arm one site with exactly one trigger (p / every / once).  Does
    NOT enable injection — call :func:`on`."""
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r}; sites: {SITES}")
    if sum((p > 0, every > 0, bool(once))) != 1:
        raise ValueError(f"{site}: exactly one trigger of p=/every=/once required")
    s = _Site(name=site, p=float(p), every=int(every), once=bool(once),
              seed=int(seed), info=int(info))
    # per-site stream: the same seed arms several sites independently
    s.rng = random.Random(f"{s.seed}:{site}")
    with _lock:
        _sites[site] = s


def disarm(site: str) -> None:
    with _lock:
        _sites.pop(site, None)


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
            hit = s.fired == 0
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


def _with_first(t: torch.Tensor, value) -> torch.Tensor:
    """A fresh copy of ``t``, on its own device, with its first element
    set to ``value``."""
    out = t.clone(memory_format=torch.contiguous_format)
    out.view(-1)[0] = value
    return out


def corrupt(site: str, t: torch.Tensor) -> torch.Tensor:
    """Return ``t`` with its first element NaN-poisoned when the site
    fires, unchanged otherwise."""
    if not _enabled or fire(site) is None:
        return t
    return _with_first(t, float("nan"))


def poison_info(site: str, info: torch.Tensor) -> torch.Tensor:
    """Force the first entry of an ``info`` vector to the site's
    ``info=`` value when it fires, unchanged otherwise."""
    if not _enabled:
        return info
    s = fire(site)
    return info if s is None else _with_first(info, s.info)


def stats() -> Dict[str, dict]:
    """Per-site {calls, fired} counters for every armed site."""
    with _lock:
        return {k: {"calls": v.calls, "fired": v.fired} for k, v in _sites.items()}
