"""Capacity-signal aggregator (the JAX package's ``scale/signals.py``):
everything the serve tier already emits about pressure, folded into one
smoothed :class:`PressureSnapshot`.

The serve tier publishes its load story piecemeal -- the admission
plane's budget-burn EWMA and overload level, the integrity plane's
hedge counter, the batcher's ``serve.bucket_pad_waste``, each lane's
queue depth and head-of-line age, devmon's device-memory headroom.
None of those is a fleet-sizing signal by itself: a deep queue with a
young head is a burst the batcher will absorb, a high burn with an
empty queue is a latency-budget problem, not a capacity one.  This
module samples all of them on one clock and reduces them to a single
composite ``pressure`` scalar (1.0 = "at capacity") that the
:mod:`~slate_tpu_torch.scale.controller` thresholds against.

Determinism is the design constraint (the capacity report replays
decisions): sampling (:func:`read_raw`, which touches the live service)
is split from reduction (:meth:`SignalAggregator.update`, a pure fold
over raw dicts).  Feed the same raw stream twice and the aggregator
produces equal snapshots -- no clock reads, no randomness, all
smoothing state explicit.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

from ..aux import metrics

#: counters sampled for rate signals (cumulative -> smoothed delta/s)
_RATE_COUNTERS = {
    "requests": "serve.requests",
    "hedges": "serve.hedge.sent",
    "pad_rows": "serve.bucket_pad_waste",
}


@dataclass(frozen=True)
class PressureSnapshot:
    """One smoothed observation of serve-tier pressure.

    ``pressure`` is the composite the controller acts on: the max of the
    normalized component signals, so ANY saturated dimension (queue
    depth, head-of-line age, budget burn, overload level) pushes it past
    1.0.  Everything else is carried for the decision record --
    ``tools/capacity_report.py`` refuses scale-ups whose snapshot shows
    no driving signal."""

    t: float
    replicas: int
    queue_depth: int
    inflight: int
    queue_per_replica: float  # smoothed depth / replica
    oldest_queued_s: float  # smoothed max head-of-line age
    burn_ewma: float  # admission budget burn (0 when the plane is off)
    overload_level: int  # admission overload level (0 when off)
    request_rate: float  # smoothed submits/s
    hedge_rate: float  # smoothed hedges/s
    pad_waste_rate: float  # smoothed padded rows/s
    hbm_headroom_frac: Optional[float]  # min over the lanes' devices; None on the CPU
    pressure: float  # composite; 1.0 = at capacity


def read_raw(svc, now: Optional[float] = None) -> Dict[str, float]:
    """Sample the live service into one raw (unsmoothed) observation.

    Cheap by construction: one pass over the lanes under the service's
    condition lock, one admission snapshot (self-locked), one counter
    read, one devmon sample.  Returns plain floats so the aggregator --
    and the tests -- never need the service itself."""
    if now is None:
        now = time.monotonic()
    raw: Dict[str, float] = {"t": now}
    with svc._cond:
        reps = list(svc._replicas)
        raw["replicas"] = float(len(reps))
        raw["queue_depth"] = float(sum(len(r.q) for r in reps))
        raw["inflight"] = float(sum(len(r.inflight) for r in reps))
        oldest = 0.0
        mono = time.monotonic()  # t_submit's clock, not the caller's
        for r in reps:
            if r.q:
                oldest = max(oldest, mono - min(x.t_submit for x in r.q))
        raw["oldest_queued_s"] = oldest
    if svc._admission is not None:
        adm = svc._admission.snapshot()
        raw["burn_ewma"] = float(adm.get("burn_ewma") or 0.0)
        raw["overload_level"] = float(adm.get("overload_level") or 0)
    else:
        raw["burn_ewma"] = 0.0
        raw["overload_level"] = 0.0
    counters = metrics.counters() if metrics.is_on() else {}
    for field, name in _RATE_COUNTERS.items():
        raw[field] = float(counters.get(name, 0))
    raw["hbm_headroom_frac"] = _hbm_headroom(svc)
    return raw


def _hbm_headroom(svc) -> Optional[float]:
    """The smallest free device-memory fraction over the service's lane
    devices (None where the backend reports no memory: a CPU lane).
    Any failure of the sample reads None, as in the JAX package; the
    drills that arm the scaler hold every card snapshot to a float."""
    try:
        from ..aux import devmon

        devs = [r.device for r in svc._replicas if r.device is not None]
        rows = devmon.sample_devices(devs or None)
    except Exception:  # noqa: BLE001 -- a sampling failure is no pressure signal
        return None
    frac = None
    for row in rows:
        used, limit = row.get("bytes_in_use"), row.get("bytes_limit")
        if used is None or not limit:
            continue
        f = max(0.0, 1.0 - used / limit)
        frac = f if frac is None else min(frac, f)
    return frac


class SignalAggregator:
    """Pure fold from raw observations to :class:`PressureSnapshot`.

    EWMA-smooths the level signals (queue depth per replica, oldest age)
    and converts the cumulative counters to smoothed rates.  The
    composite ``pressure`` is the max of each signal over its reference
    scale -- the references define "at capacity":

    * ``depth_ref`` -- queued requests per replica worth one unit
    * ``age_ref``   -- head-of-line seconds worth one unit
    * ``burn_ref``  -- admission burn EWMA worth one unit
    * ``hedge_ref`` -- hedged fraction of traffic worth one unit

    The overload level feeds in directly (level 1 == pressure 1.0): when
    the admission plane is already shedding, capacity is the answer
    regardless of what the local signals say."""

    def __init__(self, alpha: float = 0.4, depth_ref: float = 4.0, age_ref: float = 0.5,
                 burn_ref: float = 0.5, hedge_ref: float = 0.25) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1]: {alpha}")
        self.alpha = float(alpha)
        self.depth_ref = float(depth_ref)
        self.age_ref = float(age_ref)
        self.burn_ref = float(burn_ref)
        self.hedge_ref = float(hedge_ref)
        self._prev: Optional[Dict[str, float]] = None
        self._ew: Dict[str, float] = {}

    def _smooth(self, key: str, value: float) -> float:
        prev = self._ew.get(key)
        cur = value if prev is None else self.alpha * value + (1.0 - self.alpha) * prev
        self._ew[key] = cur
        return cur

    def reset(self) -> None:
        self._prev = None
        self._ew.clear()

    def update(self, raw: Dict[str, float]) -> PressureSnapshot:
        now = float(raw["t"])
        replicas = max(int(raw.get("replicas", 1)), 1)
        depth = int(raw.get("queue_depth", 0))
        inflight = int(raw.get("inflight", 0))
        qpr = self._smooth("qpr", depth / replicas)
        oldest = self._smooth("oldest", float(raw.get("oldest_queued_s", 0.0)))
        burn = float(raw.get("burn_ewma", 0.0))
        level = int(raw.get("overload_level", 0))
        rates = {f: 0.0 for f in _RATE_COUNTERS}
        if self._prev is not None:
            dt = now - float(self._prev["t"])
            if dt > 0:
                for f in _RATE_COUNTERS:
                    d = float(raw.get(f, 0.0)) - float(self._prev.get(f, 0.0))
                    rates[f] = self._smooth(f, max(d, 0.0) / dt)
        self._prev = dict(raw)
        req_rate = rates["requests"]
        hedge_share = rates["hedges"] / req_rate if req_rate > 0 else 0.0
        pressure = max(qpr / self.depth_ref, oldest / self.age_ref, burn / self.burn_ref,
                       float(level), hedge_share / self.hedge_ref)
        return PressureSnapshot(
            t=now, replicas=replicas, queue_depth=depth, inflight=inflight,
            queue_per_replica=round(qpr, 6), oldest_queued_s=round(oldest, 6),
            burn_ewma=burn, overload_level=level, request_rate=round(req_rate, 6),
            hedge_rate=round(rates["hedges"], 6), pad_waste_rate=round(rates["pad_rows"], 6),
            hbm_headroom_frac=raw.get("hbm_headroom_frac"), pressure=round(pressure, 6),
        )
