"""Request-scoped span tracing: the part of the JAX package's
``aux/spans.py`` that the mixed-precision drivers and the serve tier
call (``is_on``, ``now``, trace ids, ``start``/``end`` for spans held
across threads, ``record`` for measured intervals, ``event``, the
``span`` block, ``current``, ``annotate``) with a bounded ring of
completed spans: the flight recorder, whose eviction pressure
(:func:`pressure`, :func:`evicted`) the service's ``health()`` reports
and whose Chrome trace-event export (:func:`export_chrome`, the JAX
package's event schema) Perfetto and ``tools/trace_stitch.py`` read.
The ring's capacity is the fixed :data:`RING`.

Zero overhead off: every entry point starts with one module-level bool
check; OFF is the default.  A span lands on the ring when it ends; an
instant event lands at once::

    from slate_tpu_torch.aux import spans
    spans.on()
    with spans.span("solve"):
        X, info, iters = gesv_mixed(A, B)   # annotates refine_iters
    spans.snapshot()
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

#: capacity of the ring of completed spans (oldest evicted)
RING = 4096

_enabled = False
_lock = threading.Lock()
_ring: deque = deque(maxlen=RING)
_evicted = 0
_t0: Optional[float] = None
_ids = itertools.count(1)  # span ids (next() is atomic under the GIL)
_trace_ids = itertools.count(1)
_tls = threading.local()  # per-thread stack of context-managed spans


def now() -> float:
    """The span clock (monotonic, the metrics timers' clock)."""
    return time.perf_counter()


class Span:
    """One named interval ``[t_start, t_end]`` on a thread / lane, with a
    trace id, a parent span id and an attrs dict; ``kind`` is "span" or
    "instant"."""

    __slots__ = ("name", "trace", "sid", "parent", "t_start", "t_end", "thread",
                 "lane", "kind", "attrs")

    def __init__(self, name, trace=None, parent=None, lane=None, kind="span",
                 attrs=None, t_start=None):
        self.name = name
        self.trace = trace
        self.sid = next(_ids)
        self.parent = parent.sid if isinstance(parent, Span) else parent
        self.t_start = now() if t_start is None else t_start
        self.t_end: Optional[float] = None
        self.thread = threading.get_ident()
        self.lane = lane
        self.kind = kind
        self.attrs = dict(attrs) if attrs else {}

    def __repr__(self):  # debugging aid, never parsed
        return f"Span({self.name!r}, sid={self.sid}, attrs={self.attrs})"


def on() -> None:
    """Enable span recording."""
    global _enabled, _t0
    with _lock:
        if _t0 is None:
            _t0 = now()
        _enabled = True


def off() -> None:
    global _enabled
    _enabled = False


def is_on() -> bool:
    return _enabled


def capacity() -> int:
    return RING


def clear() -> None:
    global _evicted, _t0
    with _lock:
        _ring.clear()
        _evicted = 0
        _t0 = now() if _enabled else None


def evicted() -> int:
    """Completed spans the bounded ring has dropped (oldest first)."""
    return _evicted


def pressure() -> dict:
    """The flight recorder's eviction pressure: capacity, fill,
    lifetime evictions and the coverage window (newest end minus oldest
    start across the ring).  A nonzero ``evicted`` with a short
    ``window_s`` means a recording taken now is already truncated."""
    with _lock:
        size = len(_ring)
        window = 0.0
        if size:
            newest = _ring[-1]
            window = ((newest.t_end if newest.t_end is not None else newest.t_start)
                      - _ring[0].t_start)
        return {"capacity": RING, "size": size, "evicted": _evicted,
                "window_s": round(max(window, 0.0), 6)}


def new_trace() -> str:
    """A fresh trace id (one per serve request)."""
    return f"t{os.getpid():x}-{next(_trace_ids):x}"


def _push(sp: Span) -> None:
    global _evicted
    with _lock:
        if len(_ring) == RING:
            _evicted += 1
        _ring.append(sp)


def start(name: str, trace: Optional[str] = None, parent=None,
          lane: Optional[str] = None, **attrs) -> Optional[Span]:
    """Open a span that :func:`end` completes, for lifecycle spans held
    across threads (the :class:`span` block is the single-thread form).
    None when tracing is off."""
    if not _enabled:
        return None
    return Span(name, trace=trace, parent=parent, lane=lane, attrs=attrs)


def end(sp: Optional[Span], **attrs) -> None:
    """Stamp ``t_end``, merge ``attrs`` and push onto the ring.
    Idempotent: a span already ended is left as it is (the first
    outcome wins, as with Future.set_result)."""
    if sp is None or not _enabled or sp.t_end is not None:
        return
    sp.t_end = now()
    if attrs:
        sp.attrs.update(attrs)
    _push(sp)


def record(name: str, t_start: float, t_end: float, trace: Optional[str] = None,
           parent=None, lane: Optional[str] = None, kind: str = "span",
           **attrs) -> Optional[Span]:
    """Append one already-measured interval (both times from :func:`now`):
    a batch's per-item execute spans, planned backoff windows."""
    if not _enabled:
        return None
    sp = Span(name, trace=trace, parent=parent, lane=lane, kind=kind, attrs=attrs,
              t_start=t_start)
    sp.t_end = t_end
    _push(sp)
    return sp


def event(name: str, trace: Optional[str] = None, parent=None,
          lane: Optional[str] = None, **attrs) -> Optional[Span]:
    """Instant event (zero duration), on the ring at once."""
    if not _enabled:
        return None
    t = now()
    return record(name, t, t, trace=trace, parent=parent, lane=lane, kind="instant",
                  **attrs)


class span:
    """Context manager for nested single-thread spans: parents onto the
    innermost active span of this thread (or an explicit ``parent``, a
    request's root span held by another thread) and becomes
    :func:`current` inside the block, so :func:`annotate` reaches it."""

    __slots__ = ("name", "trace", "lane", "parent", "attrs", "_sp")

    def __init__(self, name: str, trace: Optional[str] = None,
                 lane: Optional[str] = None, parent=None, **attrs):
        self.name = name
        self.trace = trace
        self.lane = lane
        self.parent = parent
        self.attrs = attrs
        self._sp: Optional[Span] = None

    def __enter__(self) -> Optional[Span]:
        if not _enabled:
            return None
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        parent = self.parent if self.parent is not None else (stack[-1] if stack else None)
        tr = self.trace
        if tr is None and isinstance(parent, Span):
            tr = parent.trace
        self._sp = Span(self.name, trace=tr, parent=parent, lane=self.lane,
                        attrs=self.attrs)
        stack.append(self._sp)
        return self._sp

    def __exit__(self, exc_type, *exc) -> bool:
        sp = self._sp
        if sp is None:
            return False
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is sp:
            stack.pop()
        if exc_type is not None:
            sp.attrs.setdefault("outcome", exc_type.__name__)
        end(sp)
        return False


def current() -> Optional[Span]:
    """The innermost context-managed span on this thread (None when
    off or outside every block)."""
    if not _enabled:
        return None
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def annotate(_sp: Optional[Span] = None, **attrs) -> None:
    """Merge attrs into ``_sp`` (or this thread's :func:`current` span).
    The hook the refine drivers use to stamp iteration counts onto
    whatever span their caller is inside.  No-op when off/outside."""
    if not _enabled:
        return
    sp = _sp if _sp is not None else current()
    if sp is not None:
        sp.attrs.update(attrs)


def snapshot() -> List[Span]:
    """The ring's completed spans, oldest first."""
    with _lock:
        return list(_ring)


def by_trace() -> Dict[str, List[Span]]:
    """Ring spans grouped by trace id (spans without one are dropped):
    a delivered request's trace holds a completed ``request`` root and
    its lifecycle children."""
    out: Dict[str, List[Span]] = {}
    for sp in snapshot():
        if sp.trace is not None:
            out.setdefault(sp.trace, []).append(sp)
    return out


def export_chrome(path: str, process_name: Optional[str] = None) -> str:
    """Write the ring as Chrome trace-event JSON (``traceEvents``; open
    in Perfetto or chrome://tracing).  Spans with a ``lane`` share a
    named tid, lane-less spans get one tid an OS thread; ``args`` carry
    the ``trace`` / ``span`` / ``parent`` ids and the attrs; instants
    are ``"ph": "i"``, intervals ``"ph": "X"`` with ``dur`` in µs.
    ``process_name`` labels the pid track (what ``tools/trace_stitch.py``
    shows for each host)."""
    pid = os.getpid()
    tids: Dict[str, int] = {}

    def tid_for(sp: Span) -> int:
        key = sp.lane if sp.lane is not None else f"thread-{sp.thread}"
        if key not in tids:
            tids[key] = len(tids)
        return tids[key]

    items = snapshot()
    t0 = min((sp.t_start for sp in items), default=_t0 or 0.0)
    evs = []
    for sp in items:
        args = {"span": sp.sid}
        if sp.trace is not None:
            args["trace"] = sp.trace
        if sp.parent is not None:
            args["parent"] = sp.parent
        args.update(sp.attrs)
        ev = {"name": sp.name, "cat": sp.kind, "pid": pid, "tid": tid_for(sp),
              "ts": round((sp.t_start - t0) * 1e6, 3), "args": args}
        if sp.kind == "instant":
            ev["ph"] = "i"
            ev["s"] = "p"
        else:
            ev["ph"] = "X"
            ev["dur"] = round(((sp.t_end or sp.t_start) - sp.t_start) * 1e6, 3)
        evs.append(ev)
    evs.sort(key=lambda e: e["ts"])
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": key}}
            for key, tid in sorted(tids.items(), key=lambda kv: kv[1])]
    if process_name is not None:
        meta.insert(0, {"name": "process_name", "ph": "M", "pid": pid,
                        "args": {"name": str(process_name)}})
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + evs, "displayTimeUnit": "ms"}, f)
    return path
