"""Elastic capacity plane on the card (the JAX package's ``scale``,
ROADMAP.md Queue 1 item 7c2b): the control loop from observed pressure
to replica count.

The serve tier already *measures* what matters -- the admission plane's
budget-burn EWMA and overload level, hedge and pad-waste counters,
per-lane queue depth and head-of-line age, devmon's device-memory
headroom -- and the soak recorder makes the traffic itself replayable.
This package adds the actuator:

* :mod:`slate_tpu_torch.scale.signals` -- capacity-signal aggregator:
  one clock, every pressure source, smoothed into a deterministic
  :class:`~slate_tpu_torch.scale.signals.PressureSnapshot` with a single
  composite ``pressure`` scalar (1.0 = at capacity).
* :mod:`slate_tpu_torch.scale.controller` -- hysteresis policy (min/max
  replicas, separate up/down thresholds and cool-downs, AIMD step
  sizing) driving the service's ``add_replica()`` / ``remove_replica()``
  hooks.  A scale-up lane comes live warm (``ExecutableCache.prime``
  before its worker starts); scale-down quiesces through the drain path
  and re-homes lane-affine factor-cache entries.
* :mod:`slate_tpu_torch.scale.warmup_plan` -- predictive warmup: a
  recorded trace folded offline into a warmup manifest subset + factor
  preload, ranked by traffic-weighted build cost.
* :mod:`slate_tpu_torch.scale.gate` -- the ``scale.gate.*`` gauges a
  burst drill publishes for ``tools/capacity_report.py``.

On one card every lane shares ``cuda:0``: a scale-up adds lane
concurrency, not devices.  Zero overhead off: with ``SLATE_TPU_SCALE``
unset and ``Option.ServeScale`` empty the service never imports this
package and its hot path is what it was.
"""

import sys as _sys
import types as _types

from . import controller, gate, signals, warmup_plan  # noqa: F401
from .controller import (  # noqa: F401
    AutoScaler,
    ScaleController,
    ScaleDecision,
    ScalePolicy,
    parse_spec,
    policy_from_options,
)
from .signals import PressureSnapshot, SignalAggregator  # noqa: F401
from .warmup_plan import WarmupPlan, plan_from_trace  # noqa: F401

__all__ = [
    "AutoScaler", "ScaleController", "ScaleDecision", "ScalePolicy",
    "PressureSnapshot", "SignalAggregator", "WarmupPlan",
    "parse_spec", "policy_from_options", "plan_from_trace",
    "controller", "gate", "signals", "warmup_plan",
]


# ``slate_tpu_torch`` exports the aux *routine* ``scale`` (A *= numer /
# denom, reference src/scale.cc) at top level; importing this subpackage
# rebinds the ``slate_tpu_torch.scale`` attribute to the module, which
# would break ``stt.scale(2.0, 1.0, A)`` callers.  The module is made
# callable, so both work whichever import came first.
class _CallableScaleModule(_types.ModuleType):
    def __call__(self, numer, denom, A, opts=None):
        from ..drivers.aux import scale as _scale_routine

        return _scale_routine(numer, denom, A, opts)


_sys.modules[__name__].__class__ = _CallableScaleModule
