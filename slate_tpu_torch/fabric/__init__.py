"""Streaming factor fabric: device-resident factor reuse for the serve
tier (the JAX package's ``fabric``).

- :mod:`~slate_tpu_torch.fabric.arena`: a byte-budgeted per-lane cache
  of device factor buffers beside the host
  :class:`~slate_tpu_torch.serve.factor_cache.FactorCache`.  Armed, the
  cache keeps its factors in pinned host memory and answers *what*
  factor serves a hit; the arena answers *where it already lives*, so a
  hot factor's hit dispatches with no host-to-device factor copy.
- :mod:`~slate_tpu_torch.fabric.session`: streaming least-squares
  sessions (``serve.session(A, routine="gels")``): factor once, append
  rows in O(k n^2) by Householder updates of R, solve on demand, with a
  residual fence on every solve and a counted refactor on a breakdown,
  never a wrong X.

Both are off by default: a service without an arena has
``service.arena is None`` (one branch on the hot path), and sessions
exist only through explicit calls.
"""

from .arena import (  # noqa: F401
    ARENA_ENV,
    FactorArena,
    arena_from_options,
    parse_arena_spec,
)
from .session import FactorSession  # noqa: F401
