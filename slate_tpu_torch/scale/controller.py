"""Hysteresis autoscale policy (the JAX package's ``scale/controller.py``):
pressure snapshots in, replica add/remove decisions out, with the
flap-prevention machinery (separate up/down thresholds, per-direction
cool-downs, AIMD step sizing) the Clipper / tail-at-scale literature
prescribes.

Three layers, so each is testable alone:

* :class:`ScalePolicy` -- the knobs (min/max replicas, thresholds,
  cool-downs), plus the ``SLATE_TPU_SCALE`` env grammar
  (:func:`parse_spec`).
* :class:`ScaleController` -- a PURE decision function over
  :class:`~slate_tpu_torch.scale.signals.PressureSnapshot` streams: no
  clock reads, no service handle, all state explicit.  Same snapshot
  stream in, same decision stream out.
* :class:`AutoScaler` -- the actuator: a background sampling loop (or an
  externally driven :meth:`AutoScaler.step`) that reads signals, runs
  the controller, and drives the service's ``add_replica()`` /
  ``remove_replica()`` hooks, emitting the ``scale.*`` metric family and
  ``scale_up`` / ``scale_down`` span events as it goes.

Scale-up is multiplicative-increase (1, 2, 4, ... lanes a decision while
pressure stays at or above the threshold, capped by ``step_max`` and
``max_replicas``); scale-down is additive-decrease (one lane at a time)
-- the asymmetric AIMD shape that reacts fast to saturation and gives
back capacity cautiously.  On one card every lane shares the device: a
scale-up adds lane concurrency, not devices.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from dataclasses import dataclass
from typing import List, Optional

from ..aux import metrics, spans
from . import signals as _sig

SCALE_ENV = "SLATE_TPU_SCALE"

#: decision actions
UP, DOWN, HOLD = "up", "down", "hold"


@dataclass
class ScalePolicy:
    """Autoscale knobs.  ``up_threshold`` / ``down_threshold`` are in
    composite-pressure units (1.0 = at capacity); the gap between them is
    the hysteresis band -- a fleet sitting anywhere inside it holds.
    Cool-downs are per direction: scale-up must wait ``up_cooldown_s``
    after ANY change (so a fresh lane's effect is observed before adding
    another), scale-down waits the longer ``down_cooldown_s`` (giving
    back capacity is the cheap direction to be slow in)."""

    min_replicas: int = 1
    max_replicas: int = 4
    up_threshold: float = 1.0
    down_threshold: float = 0.25
    up_cooldown_s: float = 2.0
    down_cooldown_s: float = 6.0
    step_max: int = 2
    period_s: float = 0.25  # AutoScaler sampling cadence

    def __post_init__(self) -> None:
        if self.min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1: {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(f"max_replicas {self.max_replicas} < min_replicas "
                             f"{self.min_replicas}")
        if self.down_threshold >= self.up_threshold:
            raise ValueError(f"down_threshold {self.down_threshold} must sit below "
                             f"up_threshold {self.up_threshold} (hysteresis band)")
        if self.step_max < 1:
            raise ValueError(f"step_max must be >= 1: {self.step_max}")


def parse_spec(spec: str) -> Optional[ScalePolicy]:
    """Parse the ``SLATE_TPU_SCALE`` grammar: empty/``0``/``off`` -> None
    (plane off, zero overhead), ``1``/``on`` -> defaults, or a comma list
    of ``min=<n>``, ``max=<n>``, ``up=<p>``, ``down=<p>``,
    ``up_cooldown=<s>``, ``down_cooldown=<s>``, ``step=<n>``,
    ``period=<s>`` overrides."""
    spec = (spec or "").strip()
    if not spec or spec.lower() in ("0", "off", "false", "no"):
        return None
    if spec.lower() in ("1", "on", "true", "yes"):
        return ScalePolicy()
    keys = {
        "min": ("min_replicas", int),
        "max": ("max_replicas", int),
        "up": ("up_threshold", float),
        "down": ("down_threshold", float),
        "up_cooldown": ("up_cooldown_s", float),
        "down_cooldown": ("down_cooldown_s", float),
        "step": ("step_max", int),
        "period": ("period_s", float),
    }
    kw: dict = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        k, sep, v = item.partition("=")
        k, v = k.strip().lower(), v.strip()
        if not sep or k not in keys:
            raise ValueError(f"{SCALE_ENV}={spec!r}: expected k=v with k in "
                             f"{sorted(keys)}, got {item!r}")
        name, conv = keys[k]
        kw[name] = conv(v)
    return ScalePolicy(**kw)


def policy_from_options(opts=None) -> Optional[ScalePolicy]:
    """Resolve the process/service default: ``SLATE_TPU_SCALE`` wins
    (grammar above), else ``Option.ServeScale``.  None = plane off -- the
    service never constructs a scaler."""
    from ..enums import Option
    from ..options import get_option

    spec = os.environ.get(SCALE_ENV)
    if spec is None:
        spec = str(get_option(opts, Option.ServeScale) or "")
    return parse_spec(spec)


@dataclass(frozen=True)
class ScaleDecision:
    """One controller output: what to do, by how much, and the evidence
    (the driving snapshot rides along, so the decision record is
    self-certifying -- the capacity report flags any ``up`` whose
    snapshot shows sub-threshold pressure)."""

    action: str  # up | down | hold
    delta: int  # lanes to add (up) or remove (down); 0 on hold
    reason: str
    snapshot: _sig.PressureSnapshot


class ScaleController:
    """Pure hysteresis policy over a snapshot stream.  Deterministic:
    cool-down clocks come from ``snapshot.t``, never the wall.

    The up test is ``pressure >= up_threshold`` (the JAX package's);
    ``tools/capacity_report.py`` calls an up undriven at ``pressure <=
    up_threshold``, so a snapshot at exactly the threshold (overload
    level 1 alone reads 1.0) scales up and fails that report."""

    def __init__(self, policy: Optional[ScalePolicy] = None) -> None:
        self.policy = policy or ScalePolicy()
        self._last_change_t: Optional[float] = None
        self._up_step = 1  # doubles on consecutive ups (AIMD)

    def reset(self) -> None:
        self._last_change_t = None
        self._up_step = 1

    def _cooling(self, t: float, window_s: float) -> bool:
        return self._last_change_t is not None and (t - self._last_change_t) < window_s

    def decide(self, snap: _sig.PressureSnapshot) -> ScaleDecision:
        p = self.policy
        if snap.pressure >= p.up_threshold:
            if snap.replicas >= p.max_replicas:
                return ScaleDecision(HOLD, 0, "at max_replicas", snap)
            if self._cooling(snap.t, p.up_cooldown_s):
                return ScaleDecision(HOLD, 0, "up cooldown", snap)
            delta = min(self._up_step, p.step_max, p.max_replicas - snap.replicas)
            self._up_step = min(self._up_step * 2, p.step_max)
            self._last_change_t = snap.t
            return ScaleDecision(UP, delta, f"pressure {snap.pressure} >= {p.up_threshold}",
                                 snap)
        # below the up threshold: the next saturation starts gently
        self._up_step = 1
        if snap.pressure <= p.down_threshold:
            if snap.replicas <= p.min_replicas:
                return ScaleDecision(HOLD, 0, "at min_replicas", snap)
            if self._cooling(snap.t, p.down_cooldown_s):
                return ScaleDecision(HOLD, 0, "down cooldown", snap)
            self._last_change_t = snap.t
            return ScaleDecision(DOWN, 1, f"pressure {snap.pressure} <= {p.down_threshold}",
                                 snap)
        return ScaleDecision(HOLD, 0, "in hysteresis band", snap)


class AutoScaler:
    """The actuator: samples signals, runs the controller, drives the
    service's replica lifecycle hooks.  ``start()`` spawns a daemon
    sampling thread at ``policy.period_s``; tests (and the drills) may
    instead call :meth:`step` on their own clock.

    Every applied decision lands in three places: the ``scale.*`` metric
    family (counters ``scale.decisions`` / ``scale.up`` / ``scale.down``,
    gauges ``scale.pressure`` / ``scale.replicas``), a ``{"kind":
    "scale"}`` timeline row carrying the driving snapshot, and a
    ``scale_up`` / ``scale_down`` span event.  Failures are counted,
    never raised (``scale.step_errors``, ``scale.add_failed``,
    ``scale.remove_failed``), as in the JAX package."""

    def __init__(self, svc, policy: Optional[ScalePolicy] = None,
                 aggregator: Optional[_sig.SignalAggregator] = None) -> None:
        self.svc = svc
        self.policy = policy or ScalePolicy()
        self.controller = ScaleController(self.policy)
        self.aggregator = aggregator or _sig.SignalAggregator()
        self.decisions: List[ScaleDecision] = []  # applied up/down only
        self.last: Optional[ScaleDecision] = None  # most recent step()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def describe(self) -> dict:
        """The ``health()["capacity"]`` block: the policy's knobs and the
        latest decision's evidence."""
        last = self.last
        return {
            "policy": dataclasses.asdict(self.policy),
            "running": self._thread is not None,
            "decisions": len(self.decisions),
            "pressure": last.snapshot.pressure if last is not None else None,
            "replicas": last.snapshot.replicas if last is not None else None,
            "last_action": last.action if last is not None else None,
            "last_reason": last.reason if last is not None else None,
        }

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "AutoScaler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="slate-autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.policy.period_s):
            try:
                self.step()
            except Exception:  # noqa: BLE001 -- the control loop must keep running
                metrics.inc("scale.step_errors")

    # -- one control step --------------------------------------------------

    def step(self, now: Optional[float] = None) -> ScaleDecision:
        """Sample -> decide -> act, once.  Returns the decision (which
        carries its driving snapshot)."""
        snap = self.aggregator.update(_sig.read_raw(self.svc, now))
        dec = self.controller.decide(snap)
        self.last = dec
        metrics.inc("scale.decisions")
        metrics.gauge("scale.pressure", snap.pressure)
        metrics.gauge("scale.replicas", snap.replicas)
        if dec.action == UP:
            self._apply(dec, self.svc.add_replica, "up")
        elif dec.action == DOWN:
            self._apply(dec, self.svc.remove_replica, "down")
        return dec

    def _apply(self, dec: ScaleDecision, hook, direction: str) -> None:
        """Run ``hook`` (add_replica / remove_replica) ``dec.delta`` times,
        stopping at the first failure (``scale.add_failed`` /
        ``scale.remove_failed``); one timeline row if any lane moved."""
        failed = "scale.add_failed" if direction == "up" else "scale.remove_failed"
        applied = 0
        for _ in range(dec.delta):
            try:
                name = hook()
            except Exception:  # noqa: BLE001 -- counted; the loop keeps its fleet
                metrics.inc(failed)
                break
            applied += 1
            metrics.inc(f"scale.{direction}")
            if spans.is_on():
                spans.event(f"scale_{direction}", lane=f"replica-{name}",
                            pressure=dec.snapshot.pressure, reason=dec.reason)
        if applied:
            self._record(dec, applied)

    def _record(self, dec: ScaleDecision, applied: int) -> None:
        self.decisions.append(dec)
        snap = dec.snapshot
        metrics.record_timeline({
            "kind": "scale", "t_mono": snap.t, "action": dec.action,
            "delta": applied, "reason": dec.reason,
            "pressure": snap.pressure, "replicas": snap.replicas,
            "queue_depth": snap.queue_depth,
            "oldest_queued_s": snap.oldest_queued_s,
            "burn_ewma": snap.burn_ewma,
            "overload_level": snap.overload_level,
        })
