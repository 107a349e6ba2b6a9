"""Device factor arena: byte-budgeted per-lane device residency for hot
factors (the JAX package's ``fabric/arena.py``).

Unarmed, the port's factor cache (``serve/factor_cache.py``) keeps each
factor as a tensor on its lane's device, so a hit uploads only B and the
arena has nothing to do.  Armed, the cache keeps every factor in pinned
host memory (its byte budget then counts host bytes, as in the JAX
package) and the arena owns device residency: each replica lane keeps an
LRU of device buffers keyed by the cache's fingerprint.  A hit hands the
solve dispatch the buffer already on the lane's device
(``serve.arena.upload_avoided_bytes``); a miss uploads once, with
``non_blocking=True`` on the lane's current stream, and installs.

Budget and pressure
-------------------
Per-lane byte ledger (``bytes=<N>`` in the ``SLATE_TPU_FACTOR_ARENA``
grammar): inserting past the budget evicts LRU buffers
(``serve.arena.evict``).  :meth:`FactorArena.pressure` reads the device
monitor's bytes in use (``aux/devmon.bytes_in_use``) against the
device's total (``torch.cuda.mem_get_info``) and spills the lane's LRU
half when the device, not just the arena, is past :data:`PRESSURE_FRAC`
(``serve.arena.spill``); on the CPU it is a no-op.  Spill, evict and
drop release the arena's reference, so the buffer's device memory goes
back to the allocator once the dispatch that holds it ends; the host
entry survives, so the next hit re-uploads, never refactors.

Cross-replica sharing
---------------------
:meth:`FactorArena.get` with ``any_lane=True`` finds the buffer on a
peer lane and installs a device-to-device copy on the requesting lane
(``serve.arena.cross_replica``).  On one card every lane pins
``cuda:0``, so the "copy" is ``.to`` of a tensor already there: the
same storage, installed under two lanes.  The counters and the byte
ledger count it as the JAX package does (the ledger then counts the
shared bytes once a lane).

Activation: ``SLATE_TPU_FACTOR_ARENA=1`` / ``bytes=2e9``, or
``Option.ServeFactorArena``; off by default, and meaningless without
the factor cache.  Metrics: ``serve.arena.{hit,miss,
upload_avoided_bytes,upload_bytes,spill,evict,cross_replica,drop}``
global and per lane (``serve.arena.lane.<lane>.*``), and the
``serve.arena.bytes`` / ``serve.arena.lane.<lane>.bytes`` gauges: the
arena columns of ``tools/factor_report.py``.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..aux import devmon, metrics, sync

ARENA_ENV = "SLATE_TPU_FACTOR_ARENA"

DEFAULT_MAX_BYTES = 1 << 30  # 1 GiB of device-resident factors per lane

#: spill when the device reports more than this fraction of its memory in
#: use (the arena sheds residency before the allocator starts failing)
PRESSURE_FRAC = 0.9


def _record(event: str, lane: Optional[str] = None, n: int = 1) -> None:
    """One arena event: global and per lane (the lane count is the
    replica count, bounded)."""
    if not metrics.is_on():
        return  # hit path: no names built while off
    metrics.inc(f"serve.arena.{event}", n)
    if lane is not None:
        metrics.inc(f"serve.arena.lane.{lane}.{event}", n)


def _nbytes(F) -> int:
    if isinstance(F, torch.Tensor):
        return F.numel() * F.element_size()
    return int(np.asarray(F).nbytes)


@dataclass(eq=False)
class _Slot:
    """One device-resident factor buffer (an identity, not a value)."""

    buf: torch.Tensor  # on the lane's device
    nbytes: int


class FactorArena:
    """Per-lane LRU of device-resident factor buffers under one byte
    budget a lane.  Thread-safe: every lane worker and the service's
    invalidation paths touch it."""

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES):
        self.max_bytes = max(int(max_bytes), 1)
        self._lock = sync.RLock(name="fabric.FactorArena._lock")
        self._lane_slots: Dict[str, "OrderedDict[str, _Slot]"] = {}  # guarded by: _lock
        self._bytes: Dict[str, int] = {}  # guarded by: _lock

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return sum(len(d) for d in self._lane_slots.values())

    def stats(self) -> dict:
        with self._lock:
            return {
                "max_bytes": self.max_bytes,
                "bytes": sum(self._bytes.values()),
                "entries": sum(len(d) for d in self._lane_slots.values()),
                "lanes": {lane: {"entries": len(d), "bytes": self._bytes.get(lane, 0)}
                          for lane, d in self._lane_slots.items()},
            }

    def _gauges_locked(self, lane: str) -> None:
        if not metrics.is_on():
            return
        metrics.gauge("serve.arena.bytes", sum(self._bytes.values()))
        metrics.gauge(f"serve.arena.lane.{lane}.bytes", self._bytes.get(lane, 0))

    # -- core --------------------------------------------------------------

    def get(self, fp: str, lane: str, device=None, any_lane: bool = True):
        """The device-resident buffer of one fingerprint on one lane
        (refreshing its LRU position), or None.  A same-lane hit counts
        ``hit`` and ``upload_avoided_bytes``.  With ``any_lane``, a
        buffer on a peer lane is copied to ``device`` (the requesting
        lane's) and installed here (``cross_replica``)."""
        with self._lock:
            sync.guarded(self, "_lane_slots")  # race-plane probe (no-op off)
            slots = self._lane_slots.get(lane)
            if slots is not None:
                slot = slots.get(fp)
                if slot is not None:
                    slots.move_to_end(fp)
                    _record("hit", lane)
                    _record("upload_avoided_bytes", lane, slot.nbytes)
                    return slot.buf
            src = None
            if any_lane:
                for peer, pslots in self._lane_slots.items():
                    if peer != lane and fp in pslots:
                        src = pslots[fp]
                        break
        if src is not None and device is not None:
            buf = src.buf.to(device)  # the same tensor when the lanes share a card
            _record("cross_replica", lane)
            self._install(fp, lane, buf, int(src.nbytes))
            return buf
        _record("miss", lane)
        return None

    def put(self, fp: str, lane: str, F, device=None) -> torch.Tensor:
        """Upload one host factor (a pinned tensor, or numpy) to the
        lane's device and install it (``upload_bytes``); returns the
        device buffer, which the caller dispatches.  The copy is
        ``non_blocking`` on the current stream, so the dispatch that
        follows on that stream orders after it.  A buffer alone past the
        byte budget is returned uncached.  ``device=None`` keeps the
        tensor where it is."""
        nbytes = _nbytes(F)
        F = torch.as_tensor(F)
        buf = F.to(device, non_blocking=True) if device is not None else F
        _record("upload_bytes", lane, nbytes)
        if nbytes <= self.max_bytes:
            self._install(fp, lane, buf, nbytes)
        return buf

    def _install(self, fp: str, lane: str, buf, nbytes: int) -> None:
        with self._lock:
            sync.guarded(self, "_lane_slots")  # race-plane probe (no-op off)
            slots = self._lane_slots.setdefault(lane, OrderedDict())
            old = slots.pop(fp, None)
            if old is not None:
                self._bytes[lane] = self._bytes.get(lane, 0) - old.nbytes
            slots[fp] = _Slot(buf=buf, nbytes=nbytes)
            self._bytes[lane] = self._bytes.get(lane, 0) + nbytes
            while slots and self._bytes.get(lane, 0) > self.max_bytes:
                _, victim = slots.popitem(last=False)
                self._bytes[lane] -= victim.nbytes
                _record("evict", lane)
            self._gauges_locked(lane)

    # -- pressure / lifecycle ----------------------------------------------

    def pressure(self, lane: str, device=None) -> int:
        """Spill the lane's LRU half when its device has more than
        :data:`PRESSURE_FRAC` of its memory in use: the device monitor's
        bytes in use against ``torch.cuda.mem_get_info``'s total.
        Returns the number of buffers spilled; 0 on the CPU."""
        in_use = devmon.bytes_in_use(device)
        if in_use is None:
            return 0
        try:
            limit = int(torch.cuda.mem_get_info(torch.device(device or "cuda:0"))[1])
        except Exception:  # noqa: BLE001 -- telemetry never fails a dispatch
            limit = None
        if metrics.is_on():
            metrics.gauge(f"serve.arena.lane.{lane}.hbm_bytes_in_use", in_use)
        if limit is None or in_use <= PRESSURE_FRAC * limit:
            return 0
        return self.spill(lane)

    def spill(self, lane: str, keep_frac: float = 0.5) -> int:
        """Drop the LRU ``1 - keep_frac`` of one lane's residency
        (``spill`` a buffer); returns the count."""
        spilled = 0
        with self._lock:
            slots = self._lane_slots.get(lane)
            if not slots:
                return 0
            target = int(len(slots) * float(keep_frac))
            while len(slots) > target:
                _, victim = slots.popitem(last=False)
                self._bytes[lane] -= victim.nbytes
                _record("spill", lane)
                spilled += 1
            self._gauges_locked(lane)
        return spilled

    def drop(self, fp: str) -> int:
        """Drop one fingerprint's buffers on every lane (``drop``): a
        host-cache invalidation takes the device copies with it, or a
        stale factor would keep serving.  Returns the count dropped."""
        dropped = 0
        with self._lock:
            for lane, slots in self._lane_slots.items():
                slot = slots.pop(fp, None)
                if slot is not None:
                    self._bytes[lane] -= slot.nbytes
                    _record("drop", lane)
                    self._gauges_locked(lane)
                    dropped += 1
        return dropped

    def drop_lane(self, lane: str) -> int:
        """Drop one lane's whole residency (the lane is leaving the
        pool).  Returns the count dropped."""
        with self._lock:
            slots = self._lane_slots.pop(lane, None)
            self._bytes.pop(lane, None)
            if not slots:
                return 0
            n = len(slots)
            _record("drop", lane, n)
            self._gauges_locked(lane)
            return n

    def clear(self) -> int:
        """Drop everything on every lane; returns the count dropped."""
        with self._lock:
            n = sum(len(d) for d in self._lane_slots.values())
            lanes = list(self._lane_slots)
            self._lane_slots.clear()
            self._bytes.clear()
            for lane in lanes:
                self._gauges_locked(lane)
            return n


# ---------------------------------------------------------------------------
# env / options activation: SLATE_TPU_FACTOR_ARENA=1 | bytes=N
# ---------------------------------------------------------------------------


def parse_arena_spec(spec: str) -> Optional[dict]:
    """Parse the ``SLATE_TPU_FACTOR_ARENA`` grammar: empty / ``0`` /
    ``off`` -> None (disabled), ``1`` / ``on`` -> the defaults, or a
    comma list of ``bytes=<float>``."""
    spec = (spec or "").strip()
    if not spec or spec.lower() in ("0", "off", "false", "no"):
        return None
    if spec.lower() in ("1", "on", "true", "yes"):
        return {}
    out: dict = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        k, sep, v = item.partition("=")
        k, v = k.strip().lower(), v.strip()
        if not sep:
            raise ValueError(f"{ARENA_ENV}={spec!r}: expected k=v, got {item!r}")
        if k == "bytes":
            out["max_bytes"] = int(float(v))
        else:
            raise ValueError(f"{ARENA_ENV}={spec!r}: unknown key {k!r} (bytes)")
    return out


def arena_from_options(opts=None) -> Optional[FactorArena]:
    """The process / service default: ``SLATE_TPU_FACTOR_ARENA`` wins
    (an explicit off too), else the ``Option.ServeFactorArena`` spec
    (same grammar).  None = disabled."""
    from ..enums import Option
    from ..options import get_option

    env = os.environ.get(ARENA_ENV, "")
    kw = parse_arena_spec(env)
    if kw is None:
        if env.strip():
            return None  # env explicitly off: it wins over options
        kw = parse_arena_spec(str(get_option(opts, Option.ServeFactorArena)))
        if kw is None:
            return None
    return FactorArena(**kw)
