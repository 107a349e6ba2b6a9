"""Gather-fallback accounting (reference behavior: SLATE either runs the
distributed algorithm or fails loudly -- it never silently gathers a
distributed matrix to one rank; cf. the redistribution asserts in
src/work/work_trsm.cc and the MPI-collective structure of every driver).

The port's copy of the JAX package's ``internal/fallbacks.py``.  Every
driver route that abandons the explicit SPMD path for a gathered-global
evaluation on a distributed operand calls :func:`record`:

* by default the fallback is tallied in a process-wide counter
  (:func:`counters`), so tests can assert gather-freedom;
* with ``Option.RequireSpmd`` the record raises ``DistributedException``
  instead -- the SLATE-style fail-loud contract.

On a mesh every rank takes the same route, so each rank's tally is the
JAX package's for the same call.  The port runs eagerly: a record is
made on every call that takes the route.
"""

from __future__ import annotations

from collections import Counter

_COUNTS: Counter = Counter()


def record(route: str, opts=None, detail: str = "") -> None:
    """Note that `route` fell back to a gathered global evaluation for a
    distributed operand; raise if the caller demanded SPMD execution."""
    from ..aux import metrics
    from ..enums import Option
    from ..options import get_option

    _COUNTS[route] += 1
    # mirror into the metrics registry (no-op when metrics are off):
    # `fallbacks.gathered` is the aggregate
    metrics.inc("fallbacks.gathered")
    metrics.inc(f"fallbacks.{route}")
    if get_option(opts, Option.RequireSpmd, False):
        from ..exceptions import DistributedException

        raise DistributedException(
            f"Option.RequireSpmd: '{route}' would gather a distributed "
            "matrix to a global array"
            + (f" ({detail})" if detail else "")
        )


def counters() -> dict:
    """Snapshot of fallback tallies since the last reset()."""
    return dict(_COUNTS)


def reset() -> None:
    _COUNTS.clear()
