"""Instrumented synchronization runtime of the serve tier: the lock
factories and race probes of the JAX package's ``aux/sync.py``, with
its checked runtime.

* **Lock factories** -- :func:`Lock` / :func:`RLock` /
  :func:`Condition` return plain ``threading`` objects while the
  runtime is off (decided at construction time: steady state pays
  nothing), checked wrappers once ``SLATE_TPU_SYNC_CHECK`` armed it.
  The wrappers keep each thread's held-lock set and the global
  acquisition-order graph; ``name=`` is the node a lock is keyed on.
* **Lock-order cycles** -- acquiring B while holding A records the
  edge ``A -> B`` with its stack; an acquisition closing a cycle is a
  potential deadlock, reported with both stacks.
* **Eraser-style locksets** (Savage et al., SOSP '97) -- the
  ``# guarded by:`` fields carry a ``guarded(obj, "field")`` probe at
  their access sites (one bool when off).  Per field the checker
  intersects the accessing threads' held-lock sets; an empty
  intersection on an unordered cross-thread access is reported with
  both access stacks.
* **Happens-before hand-offs** -- Condition ``notify`` / ``wait`` and
  :func:`hb_publish` / :func:`hb_receive` (threaded through Future
  resolution in ``serve/service.py``) record release / acquire edges;
  an access ordered after the previous one by such an edge transfers
  ownership instead of refining the lockset.
* **Seeded interleaving perturbation** -- with ``yield=<p>`` each
  checked acquisition flips a per-thread coin seeded by ``seed`` and the
  thread's name and sleeps ``yield_us`` µs on heads, so a schedule that
  exposed a race replays under the same spec.  The ``lock_contend``
  fault site adds hold-time inflation on top.

Spec grammar (``SLATE_TPU_SYNC_CHECK`` / :func:`configure`)::

    SLATE_TPU_SYNC_CHECK=1                          # checks on
    SLATE_TPU_SYNC_CHECK=1,seed=7,yield=0.2,yield_us=200

Violations are recorded, never raised (a checked service keeps serving,
so one stress run reports every inversion), and surface through
:func:`violations` / :func:`report`, :func:`dump` (the JSON that
``tools/race_report.py`` judges) and the ``sync.violation.{lock_order,
lockset}`` counters.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import traceback
import weakref
from typing import Dict, List, Optional, Set, Tuple

from . import metrics

SYNC_ENV = "SLATE_TPU_SYNC_CHECK"

_enabled = False
_seed = 0
_yield_p = 0.0
_yield_us = 200.0

#: guards every global table below (edge graph, field states, hand-off
#: records, violations).  A plain threading.Lock on purpose: the
#: checker must never instrument itself.
_state = threading.Lock()

# (from, to) -> first-seen acquiring stack (the edge's provenance)
_edges: Dict[Tuple[str, str], str] = {}
_adj: Dict[str, Set[str]] = {}
_violations: List[dict] = []
_inversions_seen: Set[Tuple[str, str]] = set()
# (id(obj), field) -> _FieldState.  id-keyed, but NOT alias-tolerant:
# short-lived probed objects (hedge groups — one per straggler clone)
# die and CPython reuses the address, so a stale state whose lockset
# was refined to the DEAD object's lock would empty-intersect the new
# object's lock and report a false positive.  Each state pins a
# weakref whose death callback queues the key for removal (_dead,
# drained under _state — the callback itself must never take the lock:
# a GC triggered while _state is held would deadlock)
_fields: Dict[Tuple[int, str], "_FieldState"] = {}
_dead: List[Tuple[int, str]] = []
# every Class.field label ever probed — CUMULATIVE, unlike _fields
# whose entries die with their objects: coverage assertions (the
# --race stress gate) must not depend on a short-lived hedge group
# surviving until the dump
_probed_names: Set[str] = set()
# id(obj) -> (publishing thread ident, publisher clock at release).
# Insertion-ordered and FIFO-capped: a long armed run resolves a Future
# per request and nothing ever unpublishes, so without the cap this
# table grows unboundedly.  Evicting an old record can only SUPPRESS a
# hand-off edge, i.e. risk a false positive on a reader arriving after
# _RELEASES_CAP further publishes — acceptable for a debug runtime
_releases: Dict[int, Tuple[int, int]] = {}
_RELEASES_CAP = 4096


class _TLS(threading.local):
    def __init__(self):
        self.held: List[list] = []  # [lock wrapper, reentry count]
        self.clock = 0  # advances at each hb publish
        self.received: Dict[int, int] = {}  # thread ident -> clock
        self.rng: Optional[random.Random] = None


_tls = _TLS()


class _FieldState:
    __slots__ = (
        "name", "last_thread", "last_clock", "lockset", "stack", "reported",
        "wref",
    )

    def __init__(self, name: str, thread: int, clock: int, stack: str):
        self.name = name
        self.last_thread = thread
        self.last_clock = clock
        self.lockset: Optional[Set[int]] = None  # None = exclusive so far
        self.stack = stack
        self.reported = False
        self.wref = None  # keeps the id-reuse death callback alive


# ---------------------------------------------------------------------------
# control
# ---------------------------------------------------------------------------


def on() -> None:
    """Enable the checks (one bool flips).  Locks constructed BEFORE
    arming stay plain — arm first (the env path does), then build."""
    global _enabled
    _enabled = True


def off() -> None:
    global _enabled
    _enabled = False


def is_on() -> bool:
    return _enabled


def reset() -> None:
    """Disable and clear every table (test teardown) — the faults.reset
    shape.  Per-thread held lists are left alone: wrappers keep their
    release bookkeeping consistent even across a reset."""
    global _enabled
    with _state:
        _enabled = False
        _edges.clear()
        _adj.clear()
        _violations.clear()
        _inversions_seen.clear()
        _fields.clear()
        del _dead[:]
        _probed_names.clear()
        _releases.clear()


def configure(spec: str) -> bool:
    """Parse the :data:`SYNC_ENV` grammar and arm the runtime; returns
    whether it armed.  ``""``/``0``/``off`` disarm (False); ``1``/``on``
    arm with defaults; extra ``seed=``/``yield=``/``yield_us=`` items
    tune the interleaving perturbation."""
    global _seed, _yield_p, _yield_us
    spec = (spec or "").strip()
    if not spec or spec.lower() in ("0", "off", "false", "no"):
        off()
        return False
    items = [it.strip() for it in spec.split(",") if it.strip()]
    head = items[0].lower()
    if head not in ("1", "on", "true", "yes"):
        raise ValueError(
            f"expected 1|on followed by seed=/yield=/yield_us=, got "
            f"{items[0]!r}"
        )
    # "1" means DEFAULTS, not whatever a previous configure() in this
    # process left behind — a run armed plain must not inherit stale
    # perturbation tuning (and report() must describe the real spec)
    _seed, _yield_p, _yield_us = 0, 0.0, 200.0
    for item in items[1:]:
        k, sep, v = item.partition("=")
        k, v = k.strip().lower(), v.strip()
        if not sep:
            raise ValueError(f"expected k=v, got {item!r}")
        if k == "seed":
            _seed = int(v)
        elif k == "yield":
            _yield_p = float(v)
            if not 0.0 <= _yield_p <= 1.0:
                raise ValueError(f"yield probability out of [0, 1]: {v}")
        elif k == "yield_us":
            _yield_us = float(v)
        else:
            raise ValueError(
                f"unknown key {k!r} (seed=|yield=|yield_us=)"
            )
    on()
    return True


# ---------------------------------------------------------------------------
# internals shared by the wrappers
# ---------------------------------------------------------------------------


def _stack(skip: int = 2) -> str:
    """The current stack (probe/wrapper frames trimmed), newest last."""
    return "".join(traceback.format_stack()[:-skip])


def _maybe_yield() -> None:
    """The CHESS-flavored perturbation: a seeded per-thread coin per
    acquisition; heads sleeps ``yield_us``.  Each thread draws from a
    ``Random(seed x thread name)`` stream, one draw per acquisition —
    so the coin is a pure function of (seed, thread name, acquisition
    index) and a schedule that exposed a race replays under the same
    spec."""
    if _yield_p <= 0.0:
        return
    tls = _tls
    if tls.rng is None:
        tls.rng = random.Random(
            f"{_seed}:{threading.current_thread().name}"
        )
    if tls.rng.random() < _yield_p:
        time.sleep(_yield_us / 1e6)


def _record_edge(a: "_Checked", b: "_Checked") -> None:
    """Edge ``a.name -> b.name`` (b acquired while a held); an edge
    closing a cycle is a lock-order inversion, reported with the stack
    that established the original ordering AND the one inverting it."""
    an, bn = a.name, b.name
    if an == bn:
        return  # two instances from one allocation site never order
    cur = None  # build the (expensive) stack only for new edges
    with _state:
        if (an, bn) in _edges:
            return
        cur = _stack()
        _edges[(an, bn)] = cur
        _adj.setdefault(an, set()).add(bn)
        # reverse reachability bn ->* an means the new edge closes a
        # cycle; report once per unordered pair
        path = _find_path(bn, an)
        if path is None:
            return
        pair = (min(an, bn), max(an, bn))
        if pair in _inversions_seen:
            return
        _inversions_seen.add(pair)
        other = _edges.get((path[0], path[1]), "")
        _violations.append({
            "kind": "lock_order",
            "detail": (
                f"lock-order inversion: {an} -> {bn} acquired, but "
                f"{' -> '.join(path)} was already recorded"
            ),
            "locks": [an, bn],
            "cycle": path + [bn],
            "stacks": [other, cur],
        })
    metrics.inc("sync.violation.lock_order")


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS path src ->* dst over the order graph (caller holds _state);
    None when unreachable."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _adj.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _on_acquired(lock: "_Checked") -> None:
    held = _tls.held
    for ent in held:
        if ent[0] is lock:
            ent[1] += 1  # reentrant (RLock/Condition): no new edges
            return
    if _enabled:
        for ent in held:
            _record_edge(ent[0], lock)
    held.append([lock, 1])


def _on_release(lock: "_Checked") -> None:
    held = _tls.held
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is lock:
            held[i][1] -= 1
            if held[i][1] <= 0:
                del held[i]
            return


def _held_ids() -> Set[int]:
    return {id(ent[0]) for ent in _tls.held}


def _callsite_name() -> str:
    """Default lock name: the allocation site (file:line), so unnamed
    locks still aggregate per construction site in the order graph.
    Stack shape is fixed: [... caller, factory, __init__, here]."""
    fr = traceback.extract_stack(limit=4)[0]
    return f"{os.path.basename(fr.filename)}:{fr.lineno}"


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


class _Checked:
    """Shared wrapper surface: held-set + order-graph bookkeeping
    around an inner threading primitive."""

    __slots__ = ("name", "_lk")

    def __init__(self, inner, name: Optional[str]):
        self._lk = inner
        self.name = name or _callsite_name()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking:
            _maybe_yield()
            from . import faults  # late: avoid import-order surprises

            faults.sleep("lock_contend")
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            _on_acquired(self)
        return ok

    def release(self) -> None:
        _on_release(self)
        self._lk.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class _CheckedLock(_Checked):
    __slots__ = ()

    def locked(self) -> bool:
        return self._lk.locked()


class _CheckedRLock(_Checked):
    __slots__ = ()


class _CheckedCondition:
    """Checked ``threading.Condition`` over its own RLock, with
    hand-off edges: ``notify``/``notify_all`` publish, a returning
    ``wait`` receives — so a field written before notify and read
    after wait is ordered, not a lockset violation."""

    __slots__ = ("name", "_inner", "_cond")

    def __init__(self, name: Optional[str]):
        self.name = name or _callsite_name()
        self._inner = threading.RLock()
        self._cond = threading.Condition(self._inner)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking:
            _maybe_yield()
            from . import faults

            faults.sleep("lock_contend")
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _on_acquired(self)
            # receive the latest publish at ACQUIRE too, not only at a
            # wait() return: notify runs under this lock, so any
            # publish visible here is lock-ordered before us — without
            # this, a consumer that finds its predicate already true
            # (producer notified before the consumer entered the
            # with-block) never waits, never receives, and the
            # documented hand-off pattern false-positives the lockset
            # checker
            hb_receive(self)
        return ok

    def release(self) -> None:
        _on_release(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def wait(self, timeout: Optional[float] = None):
        # wait() drops the lock while blocked: the held set must agree,
        # or every waiter would deadlock the lockset/order accounting
        _on_release(self)
        try:
            got = self._cond.wait(timeout)
        finally:
            _on_acquired(self)
        # receive the latest publish even on a timeout wake: an
        # over-approximated hand-off can only SUPPRESS reports (this
        # checker is false-positive-averse by design)
        hb_receive(self)
        return got

    def wait_for(self, predicate, timeout: Optional[float] = None):
        # delegate to wait() so the held-set/hand-off bookkeeping
        # applies per wakeup, mirroring threading.Condition.wait_for
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = time.monotonic() + timeout
                waittime = endtime - time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait()
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        hb_publish(self)
        self._cond.notify(n)

    def notify_all(self) -> None:
        hb_publish(self)
        self._cond.notify_all()


def Lock(name: Optional[str] = None):
    """A mutex: plain ``threading.Lock`` when the runtime is off (the
    construction-time zero-overhead decision), a checked wrapper when
    armed.  ``name`` labels the lock in the order graph and reports —
    name per ALLOCATION SITE (all instances share the node), which is
    what lock-order analysis wants."""
    if not _enabled:
        return threading.Lock()
    return _CheckedLock(threading.Lock(), name)


def RLock(name: Optional[str] = None):
    if not _enabled:
        return threading.RLock()
    return _CheckedRLock(threading.RLock(), name)


def Condition(name: Optional[str] = None):
    if not _enabled:
        return threading.Condition()
    return _CheckedCondition(name)


# ---------------------------------------------------------------------------
# happens-before hand-off edges
# ---------------------------------------------------------------------------


def hb_publish(obj) -> None:
    """Record a release edge on ``obj`` (a Condition about to notify, a
    Future about to resolve): the publishing thread's writes so far
    happen-before any thread that later :func:`hb_receive`\\ s the same
    object.  One bool when off."""
    if not _enabled:
        return
    tls = _tls
    with _state:
        _releases.pop(id(obj), None)  # re-publish moves to newest
        _releases[id(obj)] = (threading.get_ident(), tls.clock)
        while len(_releases) > _RELEASES_CAP:
            _releases.pop(next(iter(_releases)))
    tls.clock += 1


def hb_receive(obj) -> None:
    """Record the acquire edge pairing :func:`hb_publish` (a waiter
    waking, a client reading a resolved Future's payload)."""
    if not _enabled:
        return
    with _state:
        rec = _releases.get(id(obj))
    if rec is None:
        return
    tid, clk = rec
    recv = _tls.received
    if recv.get(tid, -1) < clk:
        recv[tid] = clk


# ---------------------------------------------------------------------------
# the lockset checker
# ---------------------------------------------------------------------------


def guarded(obj, field: str, write: bool = True) -> None:
    """Eraser-style lockset probe on one annotated shared field.  Call
    adjacent to the access (``sync.guarded(rep, "q")``); one bool when
    the runtime is off.

    Algorithm (per ``(obj, field)``): the first thread owns the field
    exclusively; an access from a second thread that is happens-before
    ordered after the previous access (Condition hand-off, Future
    resolution) TRANSFERS ownership; an unordered cross-thread access
    intersects the candidate lockset with the accessing thread's held
    checked locks — an empty intersection means no lock consistently
    guards the field, reported once per field with both access
    stacks."""
    if not _enabled:
        return
    tls = _tls
    t = threading.get_ident()
    violation = None
    # format the stack BEFORE taking the global lock: every probe needs
    # one retained (the previous-access half of a future report), but
    # string-formatting it under _state would serialize every
    # instrumented thread on the hot path — flattening the very
    # interleavings the seeded yields exist to widen
    stk = _stack()
    with _state:
        while _dead:  # drain id-reuse invalidations queued by GC
            _fields.pop(_dead.pop(), None)
        key = (id(obj), field)
        st = _fields.get(key)
        if st is None:
            st = _FieldState(
                f"{type(obj).__name__}.{field}", t, tls.clock, stk
            )
            _probed_names.add(st.name)
            try:
                # when obj dies its address may be reused: queue the
                # state for removal (append only — taking _state from
                # a GC callback could deadlock)
                st.wref = weakref.ref(
                    obj, lambda _r, _k=key: _dead.append(_k)
                )
            except TypeError:
                pass  # not weakref-able: accept the rare alias
            _fields[key] = st
            return
        if st.last_thread != t:
            if tls.received.get(st.last_thread, -1) >= st.last_clock:
                # hand-off: ownership transfers, lockset resets — the
                # Condition/Future publication pattern is not a race
                st.lockset = None
            else:
                held = _held_ids()
                st.lockset = (
                    held if st.lockset is None else st.lockset & held
                )
                if not st.lockset and not st.reported:
                    st.reported = True
                    violation = {
                        "kind": "lockset",
                        "detail": (
                            f"unguarded shared access: {st.name} "
                            "touched by two threads with no common "
                            "lock and no happens-before edge"
                        ),
                        "field": st.name,
                        "write": bool(write),
                        "stacks": [st.stack, stk],
                    }
                    _violations.append(violation)
        st.last_thread = t
        st.last_clock = tls.clock
        st.stack = stk
    if violation is not None:
        metrics.inc("sync.violation.lockset")


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------


def violations() -> List[dict]:
    with _state:
        return [dict(v) for v in _violations]


def order_edges() -> List[dict]:
    """The runtime lock-order graph observed so far."""
    with _state:
        return [
            {"from": a, "to": b} for a, b in sorted(_edges)
        ]


def report() -> dict:
    """One JSON-able snapshot: violations (with stacks), the observed
    order graph, and table sizes — what :func:`dump` writes and
    ``tools/race_report.py`` judges."""
    with _state:
        return {
            "version": 1,
            "enabled": _enabled,
            "seed": _seed,
            "yield_p": _yield_p,
            "violations": [dict(v) for v in _violations],
            "edges": [
                {"from": a, "to": b} for a, b in sorted(_edges)
            ],
            "fields": len(_fields),
            # distinct Class.field labels EVER probed (cumulative, not
            # just live states) — the stress gate asserts COVERAGE with
            # these (a fields count alone cannot tell rep.q on two
            # lanes from a hedge-group probe, and a dead hedge group
            # must still count as covered)
            "field_names": sorted(_probed_names),
        }


def dump(path: str) -> str:
    """Write :func:`report` as JSON; returns the path."""
    doc = report()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2)
        fh.write("\n")
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# env activation: SLATE_TPU_SYNC_CHECK=1[,seed=N,yield=P,yield_us=U]
# ---------------------------------------------------------------------------

_env_spec = os.environ.get(SYNC_ENV)
if _env_spec:
    # fail loud but name the knob (the faults-env pattern): silently
    # disarming a check the operator believes is active would be worse
    # than refusing to start
    try:
        configure(_env_spec)
    except (ValueError, TypeError) as e:
        raise ValueError(f"{SYNC_ENV}={_env_spec!r}: {e}") from e
