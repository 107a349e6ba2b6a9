"""Process-wide metrics registry, the part of the JAX package's
``aux/metrics.py`` that the drivers and the serve tier use: counters,
gauges, per-driver wall timers, the factorization FLOP accounting, the
fixed-bucket latency histograms (:func:`observe_hist`, binned on the
JAX package's lattice, so percentiles agree bucket for bucket), the
capped key families (:class:`CappedKeys`), the :class:`phase` timer and
the counter-delta window (:class:`deltas`, with windowed histograms).
The JSONL exporter, the event timeline and the cost registry wait for
the serve planes (ROADMAP.md Queue 1 item 7b).

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
import math
import threading
import time
from typing import Callable, Dict, List, Optional

_enabled = False
_lock = threading.RLock()
_counters: Dict[str, float] = {}
_gauges: Dict[str, float] = {}
# name -> [count, total_s, min_s, max_s]
_timers: Dict[str, List[float]] = {}
_hists: Dict[str, "Histogram"] = {}


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
        _hists.clear()


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


class CappedKeys:
    """Cardinality cap for metric-name families keyed by an unbounded
    id (matrix fingerprints): the first ``cap`` distinct ids are
    tracked — :meth:`track` returns True and the caller emits its
    per-id metrics — later ids return False and the caller counts one
    overflow counter instead.  Thread-safe; one instance per family."""

    __slots__ = ("cap", "_seen", "_lock")

    def __init__(self, cap: int):
        self.cap = int(cap)
        self._seen: set = set()
        self._lock = threading.Lock()

    def track(self, key: str) -> bool:
        """True when ``key`` may emit per-key metrics (already tracked,
        or tracked now because the family is under its cap)."""
        with self._lock:
            if key in self._seen:
                return True
            if len(self._seen) < self.cap:
                self._seen.add(key)
                return True
            return False

    def __len__(self) -> int:
        return len(self._seen)

    def reset(self) -> None:
        with self._lock:
            self._seen.clear()


#: bucket lattice: 10 buckets per decade from 1 µs to 1000 s, fixed for
#: every histogram (the JAX package's lattice), so recording is one
#: log10 and one list increment
HIST_PER_DECADE = 10
HIST_LO_S = 1e-6
HIST_EDGES = tuple(
    HIST_LO_S * 10.0 ** (i / HIST_PER_DECADE)
    for i in range(9 * HIST_PER_DECADE + 1)
)


class Histogram:
    """Fixed-bucket log-spaced histogram of seconds.  Bucket 0 is the
    underflow (< ``HIST_LO_S``), bucket ``i`` covers
    ``[EDGES[i-1], EDGES[i])``, the last bucket is the overflow.
    ``percentile`` interpolates geometrically inside the winning bucket
    and clamps to the observed min/max."""

    __slots__ = ("counts", "count", "total", "min", "max")

    def __init__(self):
        self.counts = [0] * (len(HIST_EDGES) + 1)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0

    def observe(self, seconds: float) -> None:
        v = max(float(seconds), 0.0)
        if v < HIST_LO_S:
            i = 0
        else:
            i = min(int(math.log10(v / HIST_LO_S) * HIST_PER_DECADE) + 1,
                    len(HIST_EDGES))
        self.counts[i] += 1
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @staticmethod
    def percentile_from(counts, p: float, lo: Optional[float] = None,
                        hi: Optional[float] = None) -> Optional[float]:
        """p-th percentile (0..100) from a bucket-count list laid out on
        ``HIST_EDGES``."""
        total = sum(counts)
        if total <= 0:
            return None
        rank = max(1, math.ceil(p / 100.0 * total))
        cum = 0
        for i, k in enumerate(counts):
            cum += k
            if cum >= rank:
                if i == 0:
                    est = lo if lo is not None else HIST_LO_S
                elif i >= len(HIST_EDGES):
                    est = hi if hi is not None else HIST_EDGES[-1]
                else:
                    b_lo, b_hi = HIST_EDGES[i - 1], HIST_EDGES[i]
                    frac = (rank - (cum - k)) / max(k, 1)
                    est = b_lo * (b_hi / b_lo) ** frac
                if lo is not None:
                    est = max(est, lo)
                if hi is not None:
                    est = min(est, hi)
                return est
        return None

    def percentile(self, p: float) -> Optional[float]:
        return self.percentile_from(
            self.counts, p,
            lo=(self.min if self.count else None),
            hi=(self.max if self.count else None),
        )

    def summary(self) -> dict:
        return {
            "count": self.count,
            "total_s": round(self.total, 6),
            "min_s": round(self.min, 6) if self.count else 0.0,
            "max_s": round(self.max, 6),
            "p50": round(self.percentile(50) or 0.0, 6),
            "p95": round(self.percentile(95) or 0.0, 6),
            "p99": round(self.percentile(99) or 0.0, 6),
        }


def observe_hist(name: str, seconds: float) -> None:
    """Record one duration into the named histogram.  One bool check
    when metrics are off."""
    if not _enabled:
        return
    with _lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = Histogram()
        h.observe(seconds)


def percentile(name: str, p: float) -> Optional[float]:
    """p-th percentile (0..100) of a histogram; None when absent."""
    with _lock:
        h = _hists.get(name)
        return h.percentile(p) if h is not None else None


def hist_summary(name: str) -> Optional[dict]:
    """count/total/min/max/p50/p95/p99 of one histogram (None if
    absent or empty)."""
    with _lock:
        h = _hists.get(name)
        return h.summary() if h is not None and h.count else None


def histograms() -> Dict[str, dict]:
    with _lock:
        return {k: h.summary() for k, h in _hists.items() if h.count}


def _hist_counts() -> Dict[str, tuple]:
    """Raw (counts, count, total) snapshot — the deltas window state."""
    with _lock:
        return {k: (tuple(h.counts), h.count, h.total) for k, h in _hists.items()}


class phase:
    """Context manager timing one phase into the named timer.
    ``always=True`` measures even with metrics off (for callers that
    need ``.seconds``) but records only when metrics are on."""

    __slots__ = ("name", "always", "seconds", "_start")

    def __init__(self, name: str, always: bool = False):
        self.name = name
        self.always = always
        self.seconds = 0.0
        self._start = 0.0

    def __enter__(self):
        if _enabled or self.always:
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._start == 0.0:
            return False
        self.seconds = time.perf_counter() - self._start
        observe(self.name, self.seconds)
        return False


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
    live increment since, ``d.hist(name)`` the window's histogram
    percentiles.  Tests use it to read a call's counters without a
    global reset::

        with metrics.deltas() as d:
            ...
        assert d.get("jit.compilations") == 0
    """

    def __enter__(self):
        self._before = counters()
        self._hbefore = _hist_counts()
        return self

    def __exit__(self, *exc):
        return False

    def get(self, name: str) -> float:
        return counters().get(name, 0) - self._before.get(name, 0)

    def hist(self, name: str) -> Optional[dict]:
        """count/total/p50/p95/p99 over the observations recorded since
        __enter__ (bucket-count deltas); None when nothing landed."""
        cur = _hist_counts().get(name)
        if cur is None:
            return None
        before = self._hbefore.get(name)
        if before is None:
            counts, dc, dt = list(cur[0]), cur[1], cur[2]
        else:
            counts = [a - b for a, b in zip(cur[0], before[0])]
            dc, dt = cur[1] - before[1], cur[2] - before[2]
        if dc <= 0:
            return None
        return {
            "count": dc,
            "total_s": round(dt, 6),
            "p50": round(Histogram.percentile_from(counts, 50) or 0.0, 6),
            "p95": round(Histogram.percentile_from(counts, 95) or 0.0, 6),
            "p99": round(Histogram.percentile_from(counts, 99) or 0.0, 6),
        }

    def all(self) -> Dict[str, float]:
        now = counters()
        keys = sorted(set(now) | set(self._before))
        out = {k: now.get(k, 0) - self._before.get(k, 0) for k in keys}
        return {k: v for k, v in out.items() if v}
