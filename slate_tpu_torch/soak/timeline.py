"""Health timeline: background-cadence sampling of ``health()`` +
devmon gauges into ``{"type": "timeline"}`` metrics rows (the JAX
package's ``soak/timeline.py``).

Every existing report row is an end-of-run aggregate -- a quarantine
storm that engaged and recovered mid-soak, a queue that spiked and
drained, an adaptive window that collapsed and re-widened are all
invisible by dump time.  The sampler turns the probe surface into a
bounded time series (``metrics.record_timeline`` caps rows like the
event buffer) that ``tools/soak_report.py`` scans for disruption and
recovery intervals.

Zero overhead off: nothing samples until a sampler is constructed and
started; the serve tier itself is untouched (the sampler is a reader
of ``health()``, which was already designed to be polled)."""

from __future__ import annotations

import threading
from typing import Optional

from ..aux import metrics


def sample_row(svc) -> dict:
    """One timeline row from a service's ``health()`` + the registry:
    queue / inflight depth, breaker and quarantine state, burn tiers,
    span-ring pressure, factor-cache bytes, adaptive windows, device
    memory gauges -- the scalars whose TRAJECTORY the verdict reads
    (recovery times per disruption), alongside cumulative shed / hedge
    / integrity counters so rates are one difference away."""
    h = svc.health()
    c = metrics.counters()
    g = metrics.gauges()
    row = {
        "ready": bool(h.get("ready")),
        "phase": h.get("phase"),
        "queue_depth": int(h.get("queue_depth") or 0),
        "inflight": int(h.get("inflight") or 0),
        "breakers_open": len(h.get("open_buckets") or ()),
        "worker_restarts": int(h.get("worker_restarts") or 0),
        "failures_60s": int(h.get("failures_60s") or 0),
        "shed": int(c.get("serve.shed", 0)),
        "deadline_miss": int(c.get("serve.deadline_miss", 0)),
        "hedge_sent": int(c.get("serve.hedge.sent", 0)),
        "integrity_fail": int(c.get("serve.integrity.fail", 0)),
        "burn_exhausted": int(c.get("serve.slo_burn.exhausted", 0)),
    }
    integ = h.get("integrity")
    if integ is not None:
        row["quarantined"] = len(integ.get("quarantined") or ())
    ring = h.get("trace_ring")
    if ring is not None:
        row["ring_evicted"] = int(ring.get("evicted", 0))
    fc = h.get("factor_cache")
    if fc is not None:
        row["factor_cache_bytes"] = int(fc.get("bytes", 0) or 0)
        row["factor_cache_entries"] = int(fc.get("entries", 0) or 0)
    adm = h.get("admission")
    if adm is not None:
        row["overload_level"] = adm.get("overload_level")
        windows = [
            v for name, v in g.items()
            if name.startswith("serve.adaptive.")
            and name.endswith(".window_s")
        ]
        if windows:
            row["adaptive_window_min_s"] = round(min(windows), 6)
    hbm = [
        v for name, v in g.items()
        if name.startswith("devmon.") and name.endswith(".bytes_in_use")
    ]
    if hbm:
        row["hbm_bytes_in_use"] = int(sum(hbm))
    return row


class TimelineSampler:
    """Daemon-thread sampler: one :func:`sample_row` every
    ``period_s`` into the registry's timeline buffer.  ``stop()``
    takes a final sample (the run's terminal state always lands in
    the dump) and joins.  Sampling failures are counted in
    :attr:`errors`, never raised -- a mid-soak probe hiccup (e.g.
    racing a worker restart) must not kill the soak, so every caller
    asserts ``errors == 0`` at the end."""

    def __init__(self, svc, period_s: float = 0.05):
        self.svc = svc
        self.period_s = max(float(period_s), 0.001)
        self.errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _sample_once(self) -> None:
        try:
            metrics.record_timeline(sample_row(self.svc))
        except Exception:  # noqa: BLE001 — counted, never raised (see class doc)
            self.errors += 1

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            self._sample_once()

    def start(self) -> "TimelineSampler":
        if self._thread is None:
            self._stop.clear()
            self._sample_once()  # t=0 baseline row
            self._thread = threading.Thread(
                target=self._loop, name="soak-timeline", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> "TimelineSampler":
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10.0)
            self._thread = None
            self._sample_once()  # terminal state
        return self

    def __enter__(self) -> "TimelineSampler":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
