"""Request-scoped span tracing: the part of the JAX package's
``aux/spans.py`` that the mixed-precision drivers call (``is_on``,
``current``, ``annotate``, ``event``, the ``span`` block) with a bounded
ring of completed spans.  The flight recorder's export, pressure and
trace-id machinery come with the serve planes (ROADMAP.md Queue 1
item 7).

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
import threading
import time
from collections import deque
from typing import List, Optional

#: capacity of the ring of completed spans (oldest evicted)
RING = 4096

_enabled = False
_lock = threading.Lock()
_ring: deque = deque(maxlen=RING)
_ids = itertools.count(1)  # span ids (next() is atomic under the GIL)
_tls = threading.local()  # per-thread stack of context-managed spans


class Span:
    """One named interval ``[t_start, t_end]`` with a parent span id and
    an attrs dict; ``kind`` is "span" or "instant"."""

    __slots__ = ("name", "sid", "parent", "t_start", "t_end", "kind", "attrs")

    def __init__(self, name, parent=None, kind="span", attrs=None):
        self.name = name
        self.sid = next(_ids)
        self.parent = parent.sid if isinstance(parent, Span) else parent
        self.t_start = time.perf_counter()
        self.t_end: Optional[float] = None
        self.kind = kind
        self.attrs = dict(attrs) if attrs else {}

    def __repr__(self):  # debugging aid, never parsed
        return f"Span({self.name!r}, sid={self.sid}, attrs={self.attrs})"


def on() -> None:
    """Enable span recording."""
    global _enabled
    _enabled = True


def off() -> None:
    global _enabled
    _enabled = False


def is_on() -> bool:
    return _enabled


def clear() -> None:
    with _lock:
        _ring.clear()


def _push(sp: Span) -> None:
    with _lock:
        _ring.append(sp)


def event(name: str, parent=None, **attrs) -> Optional[Span]:
    """Instant event (zero duration), on the ring at once."""
    if not _enabled:
        return None
    sp = Span(name, parent=parent, kind="instant", attrs=attrs)
    sp.t_end = sp.t_start
    _push(sp)
    return sp


class span:
    """Context manager for nested single-thread spans: parents onto the
    innermost active span of this thread and becomes :func:`current`
    inside the block, so :func:`annotate` reaches it."""

    __slots__ = ("name", "attrs", "_sp")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self._sp: Optional[Span] = None

    def __enter__(self) -> Optional[Span]:
        if not _enabled:
            return None
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self._sp = Span(self.name, parent=stack[-1] if stack else None, attrs=self.attrs)
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
        sp.t_end = time.perf_counter()
        _push(sp)
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
