"""Process-wide metrics registry (the JAX package's ``aux/metrics.py``):
counters, gauges, per-driver wall timers, the factorization FLOP
accounting, the fixed-bucket latency histograms (:func:`observe_hist`,
binned on the JAX package's lattice, so percentiles agree bucket for
bucket), the capped key families (:class:`CappedKeys`), the
:class:`phase` timer and its event rows, the sampled timeline rows
(:func:`record_timeline`), the cost registry the device monitor fills
(:func:`record_cost`), the counter-delta window (:class:`deltas`, with
windowed histograms), :func:`summary` / :func:`report`, and the JSONL
exporter (:func:`dump`, :func:`load_jsonl`)::

    SLATE_TPU_METRICS=/path/out.jsonl python app.py   # on + dump at exit

The JSONL rows are the JAX package's, byte for byte in schema
(``{"type": "meta"|"event"|"timeline"|"counter"|"gauge"|"timer"|
"hist"|"cost", ...}``), so ``tools/tenant_report.py``,
``latency_report.py``, ``warmup_report.py`` and ``chaos_report.py``
read the port's file unchanged.

Zero overhead when off: every entry point starts with one module-level
bool check.  The JAX package's ``instrument_jit`` / ``jit`` /
``gated_jit`` and ``SLATE_TPU_METRICS_COST`` have no counterpart:
PyTorch compiles nothing per call, so the drivers call the kernels
directly and the serve cache times a core's first run on a device as
its cold build (``aux/devmon.capture_run`` records its cost row).

Wall times from :func:`instrumented` end with ``torch.cuda.synchronize``
when the driver ran on a CUDA device, so they time the work and not
the enqueue (only with metrics on; the off path adds no sync).
"""

from __future__ import annotations

import atexit
import functools
import json
import math
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from . import spans as _spans

_enabled = False
_lock = threading.RLock()
_t0: Optional[float] = None
_counters: Dict[str, float] = {}
_gauges: Dict[str, float] = {}
# name -> [count, total_s, min_s, max_s]
_timers: Dict[str, List[float]] = {}
_hists: Dict[str, "Histogram"] = {}
_events: List[dict] = []
_costs: Dict[str, dict] = {}
_timeline: List[dict] = []

_MAX_EVENTS = 200_000
_MAX_TIMELINE = 100_000
_dropped_events = 0
_dropped_timeline = 0


def on() -> None:
    """Enable collection (starts the registry clock on first use)."""
    global _enabled, _t0
    with _lock:
        _enabled = True
        if _t0 is None:
            _t0 = time.perf_counter()


def off() -> None:
    global _enabled
    _enabled = False


def is_on() -> bool:
    return _enabled


def reset() -> None:
    """Clear every counter/gauge/timer/event (keeps on/off state)."""
    global _t0, _dropped_events, _dropped_timeline
    with _lock:
        _counters.clear()
        _gauges.clear()
        _timers.clear()
        _hists.clear()
        _events.clear()
        _costs.clear()
        _timeline.clear()
        _dropped_events = 0
        _dropped_timeline = 0
        _t0 = time.perf_counter() if _enabled else None


def inc(name: str, value: float = 1) -> None:
    """Increment a counter.  No-op (one bool check) when metrics are off."""
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


def gauge(name: str, value: float) -> None:
    """Set a gauge to its latest value."""
    if not _enabled:
        return
    with _lock:
        _gauges[name] = float(value)


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


def record_timeline(fields: Dict[str, Any]) -> None:
    """Append one sampled time-series row (the ``{"type": "timeline"}``
    JSONL rows: a mid-run trajectory, where every other row is an
    end-of-run aggregate).  Bounded: past :data:`_MAX_TIMELINE` rows the
    newest are dropped and counted in the meta line; a ``t`` stamp
    relative to the registry clock is added when absent."""
    if not _enabled:
        return
    global _dropped_timeline
    with _lock:
        if len(_timeline) >= _MAX_TIMELINE:
            _dropped_timeline += 1
            return
        row = dict(fields)
        if "t" not in row:
            row["t"] = round(time.perf_counter() - (_t0 or 0.0), 6)
        _timeline.append(row)


def timeline() -> List[dict]:
    """Snapshot of the recorded timeline rows, oldest first."""
    with _lock:
        return [dict(r) for r in _timeline]


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

    def bucket_rows(self) -> List[list]:
        """Nonzero ``[le, count]`` rows (le = the bucket's upper edge,
        ``"inf"`` for the overflow bucket): the JSONL wire form."""
        rows = []
        for i, k in enumerate(self.counts):
            if not k:
                continue
            le = ("inf" if i >= len(HIST_EDGES)
                  else float(f"{HIST_EDGES[min(i, len(HIST_EDGES) - 1)]:.9g}"))
            rows.append([le, k])
        return rows


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


def _emit_event(name: str, start: float, stop: float) -> None:
    """Append one phase's event row (bounded: past :data:`_MAX_EVENTS`
    the newest are dropped and counted) and mirror it onto the span ring
    when tracing is on, so a Chrome export shows metric phases in the
    same lanes as the request spans."""
    global _dropped_events
    ev = {"name": name, "kind": "phase", "t_start": round(start - (_t0 or start), 6),
          "dur_s": round(stop - start, 6), "thread": threading.get_ident()}
    with _lock:
        if len(_events) < _MAX_EVENTS:
            _events.append(ev)
        else:
            _dropped_events += 1
    if _spans.is_on():
        _spans.record(name, start, stop, kind="phase")


class phase:
    """Context manager timing one phase into the named timer and one
    event row.  ``always=True`` measures even with metrics off (for
    callers that need ``.seconds``) but records only when metrics are
    on."""

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
        stop = time.perf_counter()
        self.seconds = stop - self._start
        if _enabled:
            observe(self.name, self.seconds)
            _emit_event(self.name, self._start, stop)
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


def record_cost(name: str, cost: dict) -> None:
    """Record one bucket core's cost/memory row under ``name`` (the
    device monitor's capture: flops / bytes_accessed, the argument /
    output / peak byte fields, ``flops_model``, ``device_kind``), so
    the JSONL carries a ``{"type": "cost", ...}`` row and :func:`costs`
    serves it; mirrors flops / bytes / peak onto gauges.  One bool
    check when metrics are off."""
    if not _enabled:
        return
    with _lock:
        _costs[name] = dict(cost)
    if cost.get("flops", -1) > 0:
        gauge(f"{name}.flops", cost["flops"])
    if cost.get("bytes_accessed") is not None:
        gauge(f"{name}.bytes_accessed", cost["bytes_accessed"])
    if cost.get("peak_bytes") is not None:
        gauge(f"{name}.peak_bytes", cost["peak_bytes"])


def counters() -> Dict[str, float]:
    with _lock:
        return dict(_counters)


def gauges() -> Dict[str, float]:
    with _lock:
        return dict(_gauges)


def timers() -> Dict[str, dict]:
    with _lock:
        return {
            k: {"count": int(v[0]), "total_s": v[1], "min_s": v[2], "max_s": v[3]}
            for k, v in _timers.items()
        }


def costs() -> Dict[str, dict]:
    with _lock:
        return {k: dict(v) for k, v in _costs.items()}


def summary() -> dict:
    """One structured dict with everything."""
    return {
        "counters": counters(),
        "gauges": gauges(),
        "timers": {k: {kk: (round(vv, 6) if isinstance(vv, float) else vv)
                       for kk, vv in v.items()}
                   for k, v in timers().items()},
        "histograms": histograms(),
        "costs": costs(),
    }


def report() -> str:
    """Human-readable summary: timers (with achieved GFLOP/s where a
    cost row matches the timer's name and compiled once), histograms,
    then counters."""
    with _lock:
        tsnap = {k: list(v) for k, v in _timers.items()}
        csnap = dict(_counters)
        costsnap = {k: dict(v) for k, v in _costs.items()}
        hsnap = {k: h.summary() for k, h in _hists.items() if h.count}
    lines = []
    if tsnap:
        hdr = (f"{'timer':40} {'count':>6} {'total(s)':>10} {'mean(s)':>10} "
               f"{'max(s)':>10} {'GFLOP/s':>9}")
        lines += [hdr, "-" * len(hdr)]
        for name in sorted(tsnap, key=lambda k: -tsnap[k][1]):
            cnt, total, _mn, mx = tsnap[name]
            base = name.rsplit(".", 1)[0] if name.endswith((".run", ".compile")) else name
            gf = ""
            cost = costsnap.get(base)
            if (cost and cost.get("flops", -1) > 0 and not name.endswith(".compile")
                    and csnap.get(f"{base}.compilations", 0) == 1):
                mean = total / max(cnt, 1)
                if mean > 0:
                    gf = f"{cost['flops'] / mean / 1e9:9.1f}"
            lines.append(f"{name:40} {int(cnt):6d} {total:10.4f} "
                         f"{total / max(cnt, 1):10.4f} {mx:10.4f} {gf:>9}")
    if hsnap:
        hdr = (f"{'histogram':44} {'count':>6} {'p50(s)':>10} "
               f"{'p95(s)':>10} {'p99(s)':>10} {'max(s)':>10}")
        lines += ["", hdr, "-" * len(hdr)]
        for name in sorted(hsnap):
            h = hsnap[name]
            lines.append(f"{name:44} {h['count']:6d} {h['p50']:10.4f} "
                         f"{h['p95']:10.4f} {h['p99']:10.4f} {h['max_s']:10.4f}")
    if csnap:
        lines += ["", f"{'counter':50} {'value':>12}", "-" * 63]
        for name in sorted(csnap):
            v = csnap[name]
            vs = f"{int(v)}" if float(v).is_integer() else f"{v:.3g}"
            lines.append(f"{name:50} {vs:>12}")
    return "\n".join(lines) if lines else "(no metrics recorded)"


def dump(path: Optional[str] = None) -> Optional[str]:
    """Write the registry as JSONL: a meta line, every event and
    timeline row, then the counter / gauge / timer / hist / cost
    summaries.  ``path`` defaults to ``$SLATE_TPU_METRICS``; returns the
    path written (None when there is nowhere to write)."""
    path = path or os.environ.get("SLATE_TPU_METRICS")
    if not path:
        return None
    with _lock:
        events = [dict(e) for e in _events]
        csnap = dict(_counters)
        gsnap = dict(_gauges)
        tsnap = {k: list(v) for k, v in _timers.items()}
        hsnap = {k: (h.summary(), h.bucket_rows()) for k, h in _hists.items() if h.count}
        costsnap = {k: dict(v) for k, v in _costs.items()}
        tlsnap = [dict(r) for r in _timeline]
        dropped, dropped_tl = _dropped_events, _dropped_timeline
    with open(path, "w") as f:
        meta = {"type": "meta", "schema": 1, "unix_time": time.time(), "pid": os.getpid()}
        if dropped:
            meta["dropped_events"] = dropped
        if dropped_tl:
            meta["dropped_timeline"] = dropped_tl
        f.write(json.dumps(meta) + "\n")
        for ev in events:
            f.write(json.dumps({"type": "event", **ev}) + "\n")
        for row in tlsnap:
            f.write(json.dumps({"type": "timeline", **row}) + "\n")
        for name in sorted(csnap):
            f.write(json.dumps({"type": "counter", "name": name, "value": csnap[name]}) + "\n")
        for name in sorted(gsnap):
            f.write(json.dumps({"type": "gauge", "name": name, "value": gsnap[name]}) + "\n")
        for name in sorted(tsnap):
            cnt, total, mn, mx = tsnap[name]
            f.write(json.dumps({"type": "timer", "name": name, "count": int(cnt),
                                "total_s": round(total, 6), "min_s": round(mn, 6),
                                "max_s": round(mx, 6)}) + "\n")
        for name in sorted(hsnap):
            summ, buckets = hsnap[name]
            f.write(json.dumps({"type": "hist", "name": name, **summ,
                                "buckets": buckets}) + "\n")
        for name in sorted(costsnap):
            f.write(json.dumps({"type": "cost", "name": name, **costsnap[name]}) + "\n")
    return path


def load_jsonl(path: str) -> List[dict]:
    """Parse a metrics JSONL back into a list of dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


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


# env activation: SLATE_TPU_METRICS=/path/out.jsonl turns the registry on
# and dumps it at exit
if os.environ.get("SLATE_TPU_METRICS"):
    on()
    atexit.register(dump)
