"""Fleet tier: the cross-PROCESS defense fabric (the JAX package's
``fleet``; ROADMAP.md Queue 1 item 7c3).

One router process fronting N worker processes (each running its own
replica pool) over a small length-prefixed socket RPC, extending every
single-process defense plane across the process boundary:

* **global admission** — per-tenant token buckets and the burn-EWMA
  overload controller aggregated at the router (the single clock), fed
  by periodic host burn reports, so a flooding tenant is refused
  fleet-wide, not per-host.
* **host lifecycle** — heartbeat liveness, bounded RPC timeouts with
  decorrelated-jitter retry, typed fail-fast plus counted re-dispatch
  when a host dies with requests inflight, graceful drain, and
  breaker-shaped host states (live -> suspect -> dead -> rejoined).
* **cross-host hedging + SDC quarantine** — certificate failures and
  deadline-risk stragglers re-execute on a DIFFERENT host; per-host
  integrity scores quarantine whole hosts with probe recovery.
* **stitched observability** — per-host metrics JSONL and span-ring
  dumps, host-tagged fan-in (``tools/metrics_merge.py --tag``), and
  cross-process trace joins (``tools/trace_stitch.py``).

Activation is ``SLATE_TPU_FLEET`` (grammar in :mod:`.router`); with
the env unset, :func:`FleetRouter.from_env` returns None and the
serve api's single-process path is byte-identical — one ``is None``
branch, the repo-wide zero-overhead-off contract.  A worker serves on
``cuda:0`` unless ``SLATE_TPU_FLEET_DEVICE`` names another device
(``cpu`` in the CPU tests' spawn environments), beside
``SLATE_TPU_FLEET_ADDR``, its bind address.
"""

from .router import (  # noqa: F401
    FLEET_ENV,
    FleetError,
    FleetRouter,
    FleetTimeout,
    HostDead,
    note_bad_result,
    note_trace_orphans,
    parse_fleet,
)
from .wire import ProtocolError  # noqa: F401
from .worker import FleetWorker  # noqa: F401

__all__ = [
    "FLEET_ENV",
    "FleetError",
    "FleetRouter",
    "FleetTimeout",
    "FleetWorker",
    "HostDead",
    "ProtocolError",
    "note_bad_result",
    "note_trace_orphans",
    "parse_fleet",
]
