"""Process-wide metrics registry, the driver-facing part of the JAX
package's ``aux/metrics.py``: counters, gauges, per-driver wall timers,
the factorization FLOP accounting and the counter-delta window
(:class:`deltas`).  Histograms come with the serve tier (ROADMAP.md
Queue 1 item 4).

Zero overhead when off: every entry point starts with one module-level
bool check.  The JAX package's ``gated_jit`` (a metrics-gated jit of
the Cholesky kernel) has no counterpart: PyTorch runs eagerly, so the
drivers call the kernel directly.

Wall times from :func:`instrumented` end with ``torch.cuda.synchronize``
when the driver ran on a CUDA device, so they time the work and not
the enqueue (only with metrics on; the off path adds no sync).
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Callable, Dict, List

_enabled = False
_lock = threading.RLock()
_counters: Dict[str, float] = {}
_gauges: Dict[str, float] = {}
# name -> [count, total_s, min_s, max_s]
_timers: Dict[str, List[float]] = {}


def on() -> None:
    global _enabled
    _enabled = True


def off() -> None:
    global _enabled
    _enabled = False


def is_on() -> bool:
    return _enabled


def reset() -> None:
    """Clear every counter/gauge/timer (keeps on/off state)."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _timers.clear()


def inc(name: str, value: float = 1) -> None:
    """Increment a counter.  No-op (one bool check) when metrics are off."""
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


def gauge(name: str, value: float) -> None:
    if not _enabled:
        return
    with _lock:
        _gauges[name] = value


def observe(name: str, seconds: float) -> None:
    if not _enabled:
        return
    with _lock:
        t = _timers.get(name)
        if t is None:
            _timers[name] = [1, seconds, seconds, seconds]
        else:
            t[0] += 1
            t[1] += seconds
            t[2] = min(t[2], seconds)
            t[3] = max(t[3], seconds)


def _sync_cuda() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def instrumented(name: str) -> Callable:
    """Decorator: one wall-time observation and one ``<name>.calls``
    count per driver call; with metrics off, one bool check."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if not _enabled:
                return fn(*args, **kw)
            start = time.perf_counter()
            out = fn(*args, **kw)
            _sync_cuda()
            observe(name, time.perf_counter() - start)
            inc(f"{name}.calls")
            return out

        wrapper.__wrapped__ = fn
        return wrapper

    return deco


def record_factor_flops(routine: str, fl: dict) -> None:
    """Feed one factorization's schedule accounting (a dict with
    ``model``/``exec`` FLOP counts and a ``units`` shape set — see
    ops/chol_kernels ``chol_schedule_flops``) into the
    ``factor.flops_model`` / ``factor.flops_exec`` counter pair, global
    and per-routine, plus a ``factor.<routine>.compile_units`` gauge."""
    if not _enabled:
        return
    inc("factor.flops_model", fl["model"])
    inc("factor.flops_exec", fl["exec"])
    inc(f"factor.{routine}.flops_model", fl["model"])
    inc(f"factor.{routine}.flops_exec", fl["exec"])
    gauge(f"factor.{routine}.compile_units", len(fl["units"]))


def counters() -> Dict[str, float]:
    with _lock:
        return dict(_counters)


def gauges() -> Dict[str, float]:
    with _lock:
        return dict(_gauges)


def timers() -> Dict[str, dict]:
    with _lock:
        return {
            k: {"count": v[0], "total_s": v[1], "min_s": v[2], "max_s": v[3]}
            for k, v in _timers.items()
        }


class deltas:
    """Counter-delta window: snapshot on enter, ``d.get(name)`` reads the
    live increment since.  Tests use it to read a call's counters
    without a global reset::

        with metrics.deltas() as d:
            ...
        assert d.get("refine.fallbacks") == 1
    """

    def __enter__(self):
        self._before = counters()
        return self

    def __exit__(self, *exc):
        return False

    def get(self, name: str) -> float:
        return counters().get(name, 0) - self._before.get(name, 0)

    def all(self) -> Dict[str, float]:
        now = counters()
        keys = sorted(set(now) | set(self._before))
        out = {k: now.get(k, 0) - self._before.get(k, 0) for k in keys}
        return {k: v for k, v in out.items() if v}
